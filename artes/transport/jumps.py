"""Order-free jump-sum tau walks for 3-D spherical grids: loop-free exact
optical-depth integrals along a fixed ray.

The marching tau walks (cell_face + while_loop, the SoA form of
ARTES.f90:623-656 / :4542-4569) pay the WORST lane's crossing count in
lockstep every pool round — a 39x8x8 grid's peel walk crosses 40-80 cells,
which held 3-D configs at a few M photons/s (r4/r5 measurements). This
module removes the loop for surfaceless grids with the identity

  k(s) = k(0) + sum_{0 < t_i <= s} dk_i            (piecewise-constant k)
  tau(0, s_end) = k(0) * s_end + sum_i dk_i * max(0, s_end - t_i)

where the t_i are the ray's face-crossing parameters (radial spheres:
quadratic roots; theta cones: quadratic roots with nappe rejection; the
theta = 90 plane and phi half-planes: linear) and dk_i is the opacity jump
across crossing i — an ORDER-FREE sum over a trace-time-enumerable crossing
set, with no sorting and no data-dependent loop.

Decomposition: k[cell] = kbar[cr] + dk[cr, ct, cp] with kbar[m] = k[m,0,0]
(exact in f32: dk[m,0,0] == 0). The kbar part is the existing closed-form
radial walk (transport/radial.py: per-shell chord lengths — no angular
locates at all); only the dk part pays per-crossing jump evaluation, and
every dk gather reads a small per-FACE difference table:

  DR[j][a]   = dk[j, a] - dk[j-1, a]        (radial face j;  a = ct*NP+cp)
  DTT[t][m,p] = dk[m, t, p] - dk[m, t-1, p] (theta face t)
  DPP[p][m,t] = dk[m, t, p] - dk[m, t, p-1] (phi face p, wraparound)

so a face crossing costs one <=3-chunk gather plus the locate of its two
transverse indices: the radius at a crossing comes from the ray quadratic
(r^2(t) = A t^2 + 2 B t + C, and EXACTLY rf[j] at radial crossings), the
theta band from a scalar compare chain over theta_cos, and the phi wedge
from counting the (each-crossed-at-most-once, sign(L_z)-oriented)
half-plane crossings below t — no arctan anywhere.

Telescoping correctness does not depend on crossing ORDER: each jump
evaluates its transverse indices at its own crossing parameter, so the
reconstruction k(0) + sum dk_i telescopes exactly for any true ordering.
(Crossings coincident to within an ulp can mis-pair a jump's transverse
index — a ~1e-9-per-walk event class, far below the marching walk's
error-031 abandon rate.) A face the ray never reaches collapses both quadratic roots to
the perigee parameter; the inward/outward jumps then cancel EXACTLY (same
parameter, same gathered value, opposite signs).

The transport kernel (kernel.py) supplies its tables and gather
primitive through the ``env`` callbacks (kernel._jump_env). Zero-diff faces
add exact zeros, so pruning them would not change a trajectory.

Scope: 3-D (ntheta > 1 or nphi > 1) grids withOUT a Lambert surface and
without flow diagnostics; the photon floor is handled exactly like the
radial closed form (rays entering the floor sphere stop there). The
transport MARCH keeps the cell_face while_loop — but callers use
:func:`tau_walk_jumps` along the post-scatter direction as an
exit-precheck, so lanes whose sampled tau exceeds the path total never
march at all (escape marches crossed the whole grid in lockstep).
"""

from __future__ import annotations

import jax.numpy as jnp

from artes.transport import radial as RAD

BIG = 1.0e30


class JumpEnv:
    """Per-kernel environment for the jump walk.

    Scalars / trace-time structure:
      nr, NT, NP                grid shape (ints)
      a2, b2, c2, pos_eps       oblate metric + root epsilon (floats)
      rf                        list of nr+1 face-radius scalars
      rf_floor                  photon-floor radius (may be a runtime
                                scalar — per-wavelength cell_depth)
      kbar                      list of nr per-shell baseline opacities
      tcos                      list of NT+1 theta_cos face scalars
      theta_faces               list over interior faces t=1..NT-1 of
                                (tan2, is_cone, above) — tan2 a scalar,
                                is_cone/above 0/1 scalars or python bools
      phi_trig                  list over faces p=0..NP-1 of (sin, cos)
      jfaces                    iterable of radial faces j with DR != 0
                                (1..nr-1; pass all faces when unknown)
    Gather callbacks (idx is a lane-shaped i32 array):
      dr(j, a)                  DR[j][a],        a = ct * NP + cp
      dtt(t, idx)               DTT[t][idx],     idx = m * NP + cp
      dpp(p, idx)               DPP[p][idx],     idx = m * NT + ct
      dk0(idx)                  dk[idx],         idx = (cr * NT + ct) * NP + cp
      locate_m(r2)              (m, in_band): shell of squared transformed
                                radius r2 as the count of faces j in
                                [1, nr-1] with rf[j]^2 <= r2 (ties bind
                                upward), plus a validity mask. A kernel
                                that knows the angular-structure band
                                statically may return an m that is only
                                correct INSIDE the band with in_band False
                                outside — out-of-band dtt/dpp rows are
                                identically zero, so masking the jump is
                                bit-equal to gathering the zero (the XLA
                                kernel returns (full locate, None)).
    """


def _stable_roots(A, Bh, C, lin_eps=1.0e-30):
    """Both roots of A s^2 + 2 Bh s + C = 0 (q-form; A may be ~0 or
    negative for cone quadratics). Returns (lo, hi, ok)."""
    disc = Bh * Bh - A * C
    ok = disc > 0.0
    sgn = jnp.where(Bh >= 0.0, 1.0, -1.0)
    q = -(Bh + sgn * jnp.sqrt(jnp.where(ok, disc, 0.0)))
    a_safe = jnp.where(jnp.abs(A) < lin_eps, 1.0, A)
    r1 = jnp.where(jnp.abs(A) < lin_eps, BIG, q / a_safe)
    r2 = C / jnp.where(q == 0.0, 1.0, q)
    # degenerate-to-linear: A ~ 0 -> single root -C / (2 Bh)
    lin = -C / jnp.where(jnp.abs(Bh) < lin_eps, 1.0, 2.0 * Bh)
    lin_ok = (jnp.abs(A) < lin_eps) & (jnp.abs(Bh) >= lin_eps)
    lo = jnp.where(lin_ok, lin, jnp.minimum(r1, r2))
    hi = jnp.where(lin_ok, BIG, jnp.maximum(r1, r2))
    ok = ok | lin_ok
    return lo, hi, ok


def tau_walk_jumps(env, px, py, pz, dx, dy, dz, cr0, ct0, cp0):
    """Optical depth from (p, d) to the grid boundary or photon floor.

    ``cr0/ct0/cp0``: the caller's current cell (defines k(0) — no locate).
    Returns ``dict(tau, exited, surface, err)`` matching the marching
    tau-walk contract (``err`` always False — no failure modes).
    """
    nr, NT, NP = env.nr, env.NT, env.NP
    a2, b2, c2 = env.a2, env.b2, env.c2

    # ---- radial chords + kbar baseline (shared closed form) ----
    e, h, surface_hit, s_surf = RAD.ray_chords(
        a2, b2, c2, env.rf, env.rf_floor, env.pos_eps,
        px, py, pz, dx, dy, dz)
    tau_bar = RAD.tau_from_chords(e, h, surface_hit, s_surf, env.kbar)
    s_end = jnp.where(surface_hit, s_surf, h[nr])

    # ray quadratic in transformed coordinates: r^2(t) = A t^2 + 2 B t + C
    A = a2 * dx * dx + b2 * dy * dy + c2 * dz * dz
    Bq = a2 * px * dx + b2 * py * dy + c2 * pz * dz
    Cq = a2 * px * px + b2 * py * py + c2 * pz * pz

    # ---- phi half-plane crossings (each crossed at most once; needed
    # both for their own jumps and for the cp-by-counting locates) ----
    lz_pos = (px * dy - py * dx) > 0.0      # phi increasing along the ray
    s_phi = []
    if NP > 1:
        ax = a2 ** 0.5
        by = b2 ** 0.5
        for p in range(NP):
            sin_p, cos_p = env.phi_trig[p]
            denom = by * dy * cos_p - ax * dx * sin_p
            s = (ax * px * sin_p - by * py * cos_p) \
                / jnp.where(denom == 0.0, 1.0, denom)
            # correct HALF of the plane: (X cos + Y sin) > 0 at the crossing
            xs = ax * (px + s * dx)
            ys = by * (py + s * dy)
            half_ok = (xs * cos_p + ys * sin_p) > 0.0
            valid = (jnp.abs(denom) > 0.0) & (s > 0.0) & half_ok
            s_phi.append(jnp.where(valid, s, BIG))

    def cp_at(t):
        """phi wedge at parameter t: signed count of half-plane crossings
        at or below t, wrapped. Exact while the oriented crossing count is
        (phi is monotone along a straight ray: L_z is conserved)."""
        if NP == 1:
            return jnp.zeros_like(cr0)
        cnt = None
        for p in range(NP):
            c_ = (s_phi[p] <= t).astype(jnp.int32)
            cnt = c_ if cnt is None else cnt + c_
        cp_eff = jnp.where(lz_pos, cp0 + cnt, cp0 - cnt)
        cp_eff = jnp.where(cp_eff < 0, cp_eff + NP, cp_eff)
        cp_eff = jnp.where(cp_eff < 0, cp_eff + NP, cp_eff)
        cp_eff = jnp.where(cp_eff >= NP, cp_eff - NP, cp_eff)
        return jnp.where(cp_eff >= NP, cp_eff - NP, cp_eff)

    def ct_at(cos_t):
        """theta band of cos(theta): scalar compare chain over theta_cos
        (decreasing: band i has tcos[i+1] <= cos < tcos[i])."""
        if NT == 1:
            return jnp.zeros_like(cr0)
        c_ = None
        for j in range(1, NT):
            b_ = (cos_t < env.tcos[j]).astype(jnp.int32)
            c_ = b_ if c_ is None else c_ + b_
        return c_

    zero = jnp.zeros_like(px)
    dk_sum = zero

    def add(delta, t_i):
        nonlocal dk_sum
        dk_sum = dk_sum + delta * jnp.maximum(s_end - t_i, 0.0) \
            * (t_i > 0.0) * (t_i < BIG)

    # ---- initial dk (the caller's cell indexes k(0) — consistent with
    # the kernel state, like the marching walk's first cell) ----
    dk_sum = env.dk0((cr0 * NT + ct0) * NP + cp0) * s_end

    # ---- radial-face jumps (inbound at e[j]: shell j -> j-1; outbound at
    # h[j]: j-1 -> j). Unreached faces collapse e == h -> exact cancel. ----
    for j in env.jfaces:
        # cos(theta) at the crossing: transformed z over EXACT radius rf[j]
        inv_rf = 1.0 / env.rf[j]
        for (t_i, sign) in ((e[j], -1.0), (h[j], 1.0)):
            ct_i = ct_at((c2 ** 0.5) * (pz + t_i * dz) * inv_rf)
            cp_i = cp_at(t_i)
            add(sign * env.dr(j, ct_i * NP + cp_i), t_i)

    # ---- theta-face jumps ----
    if NT > 1:
        sq_c = c2 ** 0.5
        for t in range(1, NT):
            tan2, is_cone, above = env.theta_faces[t - 1]
            # cone: quadratic in transformed coords (cell_face cone form)
            qa = a2 * dx * dx + b2 * dy * dy - c2 * dz * dz * tan2
            qb = a2 * px * dx + b2 * py * dy - c2 * pz * dz * tan2
            qc = a2 * px * px + b2 * py * py - c2 * pz * pz * tan2
            lo, hi, ok = _stable_roots(qa, qb, qc)
            s_plane = -pz / jnp.where(dz == 0.0, 1.0, dz)
            plane_ok = jnp.abs(dz) > 0.0
            for root in (lo, hi):
                z_r = pz + root * dz
                if isinstance(above, bool):
                    nappe_ok = (z_r > 0.0) if above else (z_r < 0.0)
                else:
                    nappe_ok = jnp.where(jnp.asarray(above) > 0.5,
                                         z_r > 0.0, z_r < 0.0)
                cone_t = jnp.where(ok & nappe_ok, root, BIG)
                t_i = _sel_cone(is_cone, cone_t,
                                jnp.where(plane_ok, s_plane, BIG),
                                first=root is lo)
                # crossing direction: sign of d(cos theta)/ds at t_i
                r2_i = (A * t_i + 2.0 * Bq) * t_i + Cq
                u = sq_c * dz * r2_i \
                    - sq_c * (pz + t_i * dz) * (A * t_i + Bq)
                # u < 0: cos theta decreasing -> band t-1 -> t
                sign = jnp.where(u < 0.0, 1.0, -1.0)
                m_i, inb = env.locate_m(r2_i)
                cp_i = cp_at(t_i)
                d_i = env.dtt(t, m_i * NP + cp_i)
                if inb is not None:
                    d_i = d_i * inb
                add(sign * d_i, t_i)

    # ---- phi-face jumps ----
    if NP > 1:
        sign_p = jnp.where(lz_pos, 1.0, -1.0)
        for p in range(NP):
            t_i = s_phi[p]
            r2_i = (A * t_i + 2.0 * Bq) * t_i + Cq
            m_i, inb = env.locate_m(r2_i)
            ct_i = ct_at((c2 ** 0.5) * (pz + t_i * dz)
                         / jnp.sqrt(jnp.maximum(r2_i, 1.0e-30)))
            d_i = env.dpp(p, m_i * NT + ct_i)
            if inb is not None:
                d_i = d_i * inb
            add(sign_p * d_i, t_i)

    tau = jnp.maximum(tau_bar + dk_sum, 0.0)
    return dict(tau=tau, exited=~surface_hit, surface=surface_hit,
                err=jnp.zeros_like(surface_hit))


def _sel_cone(is_cone, cone_val, plane_val, first):
    """Pick the cone root or (for the first root slot only) the plane
    root; the second slot of a plane face is empty (planes cross once)."""
    if isinstance(is_cone, bool):
        if is_cone:
            return cone_val
        return plane_val if first else jnp.full_like(cone_val, BIG)
    plane = plane_val if first else jnp.full_like(cone_val, BIG)
    cone_f = jnp.asarray(is_cone, cone_val.dtype)
    return jnp.where(cone_f > 0.5, cone_val, plane)
