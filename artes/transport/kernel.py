"""The photon-transport kernel: batched, masked, jit-compiled per wavelength.

This is the batched re-design of the reference's hot loop (``radiative_transfer``
ARTES.f90:518-1006). Instead of one photon per OpenMP thread walking a branchy
state machine, a *batch* of photons advances in lockstep through fixed-shape
masked phases:

  emit -> [thermal birth peel] -> forced-first-interaction pre-walk ->
  march -> { roulette -> reweight -> peel -> scatter -> march } * rounds

Every march (transport, detector peel) is a bounded ``lax.while_loop`` whose
body performs one cell crossing for every active lane via the vectorized
:func:`~artes.transport.geometry.cell_face`. Detector accumulation is a
scatter-add into a per-batch image that the caller psum-reduces across
devices. All randomness is counter-based (``rng.py``) with per-lane draw-site
counters that advance with each photon's own event history, so every kernel
variant (single-device, sharded, vmapped, regeneration) produces the same
per-photon stream — results are independent of batch/device splits.

Lengths are in scaled units (outer radius = 1); opacities are pre-multiplied
by the length scale.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from artes.constants import PI
from artes.transport import geometry as G
from artes.transport import jumps as J
from artes.transport import mueller as M
from artes.transport import radial as RAD
from artes.transport import rng as R
from artes.transport import sampling as S

TWO_PI = 2.0 * np.pi


@dataclasses.dataclass(frozen=True)
class KernelStatic:
    """Compile-time kernel parameters."""

    nx: int
    ny: int
    photon_source: int          # 1 = star, 2 = planet (ARTES.f90:20)
    photon_emission: int = 1    # 1 = isotropic, 2 = biased (:33)
    photon_scattering: bool = True
    stellar_direction: bool = False
    crescent: bool = False      # phase-curve >=170 deg disk sampling (:1041-1055)
    thermal_weight: bool = True
    max_scatter: int = 128
    max_crossings: int = 64
    track_flow: bool = False
    # config has a Lambert surface (surface_albedo > 0). Static because the
    # closed-form radial fast path (transport/radial.py) excludes surface
    # configs at trace time — multi-bounce legs keep the marching loop.
    has_surface: bool = False
    # accumulate detector moments in float64 (needs jax_enable_x64): makes the
    # detector sum invariant to sharding/summation order at rtol ~1e-13, the
    # multi-chip equality contract (per-lane physics stays in the table dtype).
    # The analogue of the reference's double-precision detector_thread
    # reduction (ARTES.f90:959-975).
    det_f64: bool = False
    # in-kernel Stokes-anomaly check I^2 >= Q^2+U^2+V^2 after every scatter
    # (the reference's error 050, ARTES.f90:830-835): anomalous photons are
    # abandoned and tallied as n_stokes_anomaly. Debug mode — off by default,
    # the regeneration pool (run_stream) only.
    debug_stokes: bool = False


@partial(jax.tree_util.register_dataclass,
         data_fields=["grid", "opacity", "albedo", "scatter_rows", "alpha_prefix",
                      "p_int", "cell_depth", "emis_cum", "cell_weight", "det_dir",
                      "det_trig", "x_max", "y_max", "surface_albedo", "fstop",
                      "photon_minimum", "photon_bias", "star_theta", "star_phi"],
         meta_fields=[])
@dataclasses.dataclass
class TransportTables:
    """Per-wavelength device tables (pytree)."""

    grid: G.GridGeometry
    opacity: jnp.ndarray        # (ncell,) extinction per scaled length
    albedo: jnp.ndarray         # (ncell,)
    scatter_rows: jnp.ndarray   # (ncell*180, 16)
    alpha_prefix: jnp.ndarray   # (ncell, 4, 181)
    p_int: jnp.ndarray          # (ncell, 4)
    cell_depth: jnp.ndarray     # scalar int32: photon floor radial face
    emis_cum: jnp.ndarray      # (ncell,) cumulative emissivity CDF (thermal)
    cell_weight: jnp.ndarray    # (ncell,) thermal emission weights
    det_dir: jnp.ndarray        # (3,) unit vector to the observer
    det_trig: jnp.ndarray       # (4,) sin/cos det theta, sin/cos det phi
    x_max: jnp.ndarray          # scalar, scaled image half-size
    y_max: jnp.ndarray
    surface_albedo: jnp.ndarray
    fstop: jnp.ndarray
    photon_minimum: jnp.ndarray
    photon_bias: jnp.ndarray
    star_theta: jnp.ndarray
    star_phi: jnp.ndarray


def flat_cell(grid: G.GridGeometry, cell):
    return (cell[..., 0] * grid.ntheta + cell[..., 1]) * grid.nphi + cell[..., 2]


# ---------------------------------------------------------------------------
# Detector splat (segment-sum re-design of the per-thread += at
# ARTES.f90:4571-4596, :4945-4984)
# ---------------------------------------------------------------------------

def _image_coords(t: TransportTables, pos):
    """Image-plane coordinates of a splat origin (ARTES.f90:4575-4579)."""
    st, ct, sp, cp = t.det_trig[0], t.det_trig[1], t.det_trig[2], t.det_trig[3]
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    x_im = y * cp - x * sp
    y_im = z * st - y * ct * sp - x * ct * cp
    return x_im, y_im


def _pixel_index(t: TransportTables, static: KernelStatic, pos):
    x_im, y_im = _image_coords(t, pos)
    ix = jnp.floor(static.nx * (x_im + t.x_max) / (2.0 * t.x_max)).astype(jnp.int32)
    iy = jnp.floor(static.ny * (y_im + t.y_max) / (2.0 * t.y_max)).astype(jnp.int32)
    oob = (ix < 0) | (ix >= static.nx) | (iy < 0) | (iy >= static.ny)
    return jnp.where(oob, -1, ix * static.ny + iy)


# first-K error-event state capture (see _stream_impl)
ERR_RECORD_K = 8
ERR_RECORD_W = 16   # [code, pid, pos3, dir3, cell3, face2, stokesI, n_scat, site, 0]


def _splat(detector, pix, stokes4, mask, first_only: bool = False):
    """Accumulate (flux, flux^2, count) x 4 Stokes at pixel indices.

    ``detector``: (npix, 4, 3). Lanes with mask False (or out-of-image) are
    dropped. ``first_only`` mirrors the thermal/surface peels that only book
    Stokes I and its count (ARTES.f90:4583-4585, :4691-4693); peel_photon
    books all four (:4945-4972).
    """
    npix = detector.shape[0]
    ok = mask & (pix >= 0)
    # where-select, not multiply: masked lanes may hold non-finite state in
    # the regeneration kernel and 0 * nan = nan
    valid = jnp.where(ok[..., None], stokes4, 0.0)
    count = jnp.where(ok[..., None], jnp.ones_like(stokes4), 0.0)

    if first_only:
        feats = jnp.stack([valid[..., 0], valid[..., 0] ** 2, count[..., 0]],
                          axis=-1)                      # (B, 3)
    else:
        feats = jnp.stack([valid, valid * valid, count], axis=-1)  # (B, 4, 3)
        feats = feats.reshape(feats.shape[0], 12)
    # the accumulator may be wider than the per-lane physics (det_f64)
    feats = feats.astype(detector.dtype)

    if npix == 1:
        # spectrum/photometry detector: a masked sum
        acc = jnp.sum(feats, axis=0)
        if first_only:
            return detector.at[0, 0, :].add(acc)
        return detector + acc.reshape(1, 4, 3)

    # scatter-add (atomics on the GPU: moment sums change order from run to
    # run, counts stay exact). On the H100 it beat 256-pixel one-hot matmul
    # tiles 2.6x at 25x25 (PERF.md).
    idx = jnp.where(ok, pix, npix)
    if first_only:
        return detector.at[idx, 0, :].add(feats, mode="drop")
    return detector.at[idx, :, :].add(feats.reshape(-1, 4, 3), mode="drop")


# ---------------------------------------------------------------------------
# Peel walk: accumulate optical depth along the detector direction
# (the shared grid walk of peel_thermal/surface/photon, ARTES.f90:4542-4569)
# ---------------------------------------------------------------------------

def _radial_lists(t: TransportTables):
    """Scalar face/opacity lists for the closed-form radial path."""
    g = t.grid
    a2, b2, c2 = g.ob_ax * g.ob_ax, g.ob_by * g.ob_by, g.ob_cz * g.ob_cz
    rf = [g.rfront[j] for j in range(g.nr + 1)]
    kx = [t.opacity[m] for m in range(g.nr)]
    rf_floor = g.rfront[t.cell_depth]
    return a2, b2, c2, rf, kx, rf_floor, g.pos_eps


def _use_jumps(grid, static) -> bool:
    """Order-free jump walks apply: 3-D grid, no surface, no flow."""
    return ((grid.ntheta > 1 or grid.nphi > 1)
            and not static.track_flow and not static.has_surface)


def _jump_env(t: TransportTables) -> J.JumpEnv:
    """Jump-walk environment over this kernel's tables (jumps.py doc).

    Diff tables are built from ``t.opacity`` at trace time — XLA hoists
    them out of the pool loop; gathers go through ``G.gather_rows``."""
    g = t.grid
    nr, NT, NP = g.nr, g.ntheta, g.nphi
    k3 = t.opacity.reshape(nr, NT, NP)
    kbar = k3[:, 0, 0]
    dk = k3 - kbar[:, None, None]
    env = J.JumpEnv()
    env.nr, env.NT, env.NP = nr, NT, NP
    env.a2, env.b2, env.c2 = g.ob_ax * g.ob_ax, g.ob_by * g.ob_by, g.ob_cz * g.ob_cz
    env.pos_eps = g.pos_eps
    env.rf = [g.rfront[j] for j in range(nr + 1)]
    env.rf_floor = g.rfront[t.cell_depth]
    env.kbar = [kbar[m] for m in range(nr)]
    env.tcos = [g.theta_cos[j] for j in range(NT + 1)]
    # is_cone/above as 0/1 scalars (structure rides the traced grid tables)
    env.theta_faces = [(g.theta_tan[j] * g.theta_tan[j],
                        g.thetaplane_cone[j], g.theta_above[j])
                       for j in range(1, NT)]
    env.phi_trig = [(g.phi_sin[p], g.phi_cos[p]) for p in range(NP)]
    # all radial faces (zero-diff faces contribute exact zeros)
    env.jfaces = tuple(range(1, nr))
    dr_rows = {j: (dk[j] - dk[j - 1]).reshape(-1) for j in env.jfaces}
    dtt_rows = {j: (dk[:, j, :] - dk[:, j - 1, :]).reshape(-1)
                for j in range(1, NT)}
    dpp_rows = {p: (dk[:, :, p] - dk[:, :, (p - 1) % NP]).reshape(-1)
                for p in range(NP)}
    dk_flat = dk.reshape(-1)
    env.dr = lambda j, a: G.gather_rows(dr_rows[j], a)
    env.dtt = lambda j, idx: G.gather_rows(dtt_rows[j], idx)
    env.dpp = lambda p, idx: G.gather_rows(dpp_rows[p], idx)
    env.dk0 = lambda idx: G.gather_rows(dk_flat, idx)
    rf2 = jnp.stack([env.rf[j] * env.rf[j] for j in range(1, nr)]) \
        if nr > 1 else jnp.zeros((0,), t.opacity.dtype)
    env.locate_m = lambda r2: (jnp.searchsorted(
        rf2, r2, side="right").astype(jnp.int32), None)
    return env


def _peel_walk(t: TransportTables, static: KernelStatic, pos, cell, face, active):
    grid = t.grid
    if _use_jumps(grid, static):
        env = _jump_env(t)
        d = t.det_dir.astype(pos.dtype)
        B = pos.shape[0]
        o = J.tau_walk_jumps(env, pos[..., 0], pos[..., 1], pos[..., 2],
                             jnp.broadcast_to(d[0], (B,)),
                             jnp.broadcast_to(d[1], (B,)),
                             jnp.broadcast_to(d[2], (B,)),
                             cell[..., 0], cell[..., 1], cell[..., 2])
        return o["tau"], o["exited"], o["err"]
    if RAD.use_closed_form(grid, static):
        a2, b2, c2, rf, kx, rfl, peps = _radial_lists(t)
        d = t.det_dir.astype(pos.dtype)
        o = RAD.tau_walk(a2, b2, c2, rf, kx, rfl, peps,
                         pos[..., 0], pos[..., 1], pos[..., 2],
                         d[0], d[1], d[2])
        return o["tau"], o["exited"], o["err"]

    def cond(c):
        return jnp.any(c["marching"]) & (c["it"] < static.max_crossings)

    def body(c):
        out = G.cell_face(grid, c["pos"], t.det_dir, c["cell"], c["face"], t.cell_depth)
        d = out["distance"]
        tau_cell = d * G.gather_rows(t.opacity, flat_cell(grid, c["cell"]))
        m = c["marching"]
        pos_new = c["pos"] + d[..., None] * t.det_dir
        hit_surface = (out["next_face"][..., 0] == 1) & (out["next_face"][..., 1] == t.cell_depth)
        stop = out["grid_exit"] | out["error"] | hit_surface
        return {
            "pos": jnp.where(m[..., None], pos_new, c["pos"]),
            "cell": jnp.where(m[..., None], out["cell_out"], c["cell"]),
            "face": jnp.where(m[..., None], out["next_face"], c["face"]),
            "tau": c["tau"] + jnp.where(m, tau_cell, 0.0),
            "exited": c["exited"] | (m & out["grid_exit"]),
            "error": c["error"] | (m & out["error"]),
            "marching": m & ~stop,
            "it": c["it"] + 1,
        }

    init = {
        "pos": pos, "cell": cell, "face": face,
        "tau": jnp.zeros(pos.shape[:-1], pos.dtype),
        "exited": jnp.zeros(pos.shape[:-1], bool),
        "error": jnp.zeros(pos.shape[:-1], bool),
        "marching": active,
        "it": jnp.asarray(0, jnp.int32),
    }
    out = jax.lax.while_loop(cond, body, init)
    return out["tau"], out["exited"], out["error"]


def _peel_thermal(t, static, detector, pos, cell, face, stokes, active):
    """NEE at thermal birth: isotropic weight e^-tau/(4 pi) (ARTES.f90:4519-4598)."""
    tau, exited, err = _peel_walk(t, static, pos, cell, face, active)
    w = jnp.exp(-jnp.minimum(tau, 500.0)) / (4.0 * PI)
    ok = active & exited & (tau < 50.0) & ~err
    contrib = jnp.zeros(stokes.shape, stokes.dtype).at[..., 0].set(w * stokes[..., 0])
    pix = _pixel_index(t, static, pos)
    return _splat(detector, pix, contrib, ok, first_only=True), err


def _peel_surface(t, static, detector, pos, cell, face, stokes, active):
    """NEE at Lambertian reflection: weight e^-tau cos(theta)/pi (ARTES.f90:4600-4708)."""
    grid = t.grid
    a2 = grid.ob_ax * grid.ob_ax
    b2 = grid.ob_by * grid.ob_by
    c2 = grid.ob_cz * grid.ob_cz
    normal = jnp.stack([pos[..., 0] * a2, pos[..., 1] * b2, pos[..., 2] * c2], axis=-1)
    normal = normal / jnp.linalg.norm(normal, axis=-1, keepdims=True)
    cos_angle = jnp.sum(normal * t.det_dir, axis=-1)
    visible = cos_angle > 0.0

    # the reflected photon peels from the cell just above the surface with the
    # surface face as current face (ARTES.f90:4640-4644)
    cell_above = cell.at[..., 0].add(1)
    tau, exited, err = _peel_walk(t, static, pos, cell_above, face, active & visible)
    w = jnp.exp(-jnp.minimum(tau, 500.0)) * cos_angle / PI
    ok = active & visible & exited & (tau < 50.0) & ~err
    contrib = jnp.zeros(stokes.shape, stokes.dtype).at[..., 0].set(w * stokes[..., 0])
    pix = _pixel_index(t, static, pos)
    return _splat(detector, pix, contrib, ok, first_only=True)


def _peel_photon_prep(t, static, pos, dirn, cell, stokes):
    """The tau-independent part of the per-scatter peel (ARTES.f90:4763-4948):
    scattering matrix at the detector angle, azimuth bookkeeping, full-Stokes
    rotation with the detector Q sign flip, and the target pixel. The optical
    depth along the detector ray is supplied by the (merged) grid walk."""
    eps = 1.0e-10
    mu = jnp.sum(dirn * t.det_dir, axis=-1)
    mu = jnp.clip(mu, -1.0 + eps, 1.0 - eps)
    scatter = S.matrix_at_angle(t.scatter_rows, flat_cell(t.grid, cell), jnp.arccos(mu))

    # azimuth of the detector-pointing scatter (ARTES.f90:4864-4916), all in
    # cos space: cos(phi_sc) from the spherical cosine rule; the half-plane
    # branch mod(phi_old - phi_new, 2 pi) < pi reduces to the sign of the
    # cross product d x det in the xy-plane (sin(phi_old - phi_new) > 0)
    dz = dirn[..., 2]
    denom = jnp.sqrt(jnp.maximum(1.0 - mu * mu, 0.0)) * jnp.sqrt(jnp.maximum(1.0 - dz * dz, 0.0))
    num = (t.det_dir[2] - dz * mu) / jnp.where(denom == 0.0, 1.0, denom)
    cphi = jnp.clip(num, -1.0 + eps, 1.0 - eps)
    flip = (dirn[..., 1] * t.det_dir[0] - dirn[..., 0] * t.det_dir[1]) > 0.0
    sign = jnp.where(flip, -1.0, 1.0)
    c2b = 2.0 * cphi * cphi - 1.0
    s2b = 2.0 * cphi * jnp.sqrt(jnp.maximum(1.0 - cphi * cphi, 0.0)) * sign

    stokes_out = M.polarization_rotation(mu, None, stokes, scatter, dirn,
                                         jnp.broadcast_to(t.det_dir, dirn.shape),
                                         peeling=True, beta_trig=(c2b, s2b),
                                         beta_sign=sign)
    # detector Q sign flip (ARTES.f90:4956)
    contrib = stokes_out * jnp.asarray([1.0, -1.0, 1.0, 1.0], stokes.dtype)
    pix = _pixel_index(t, static, pos)
    return contrib, pix


def _peel_photon(t, static, detector, pos, dirn, cell, face, stokes, active):
    """NEE at every scattering event (ARTES.f90:4710-4990), standalone form
    (the scatter loop uses the walk merged into _march instead)."""
    tau, exited, err = _peel_walk(t, static, pos, cell, face, active)
    w = jnp.exp(-jnp.minimum(tau, 500.0))
    ok = active & exited & (tau < 50.0) & ~err
    contrib, pix = _peel_photon_prep(t, static, pos, dirn, cell, stokes)
    return _splat(detector, pix, contrib * w[..., None], ok)


# ---------------------------------------------------------------------------
# Emission (ARTES.f90:1008-1268)
# ---------------------------------------------------------------------------

def _emit(t: TransportTables, static: KernelStatic, keys, counter, dtype):
    n = keys.shape[0]
    grid = t.grid

    if static.photon_source == 1:
        # Stellar: uniform parallel beam over the *ellipsoid silhouette*.
        #
        # The reference samples the disk of the polar radius rfront(nr) on the
        # bounding sphere and force-assigns radial cell nr-1
        # (ARTES.f90:1054-1077, :2621), which for an oblate grid places entry
        # points deep inside the ellipsoid in the wrong cell (the equatorial
        # bulge is both missed by the beam and mis-located). Re-design: map to
        # the unit-sphere frame with S = diag(a,b,c) (an affine map preserves
        # uniform parallel beams), sample the unit disk perpendicular to the
        # transformed beam direction, land on the unit sphere, and map back.
        # At zero oblateness this reduces bit-exactly to the reference's disk
        # sampling. The beam cross-section is pi*Rp^2*|S u|/(abc); the runner
        # multiplies the package energy by that factor (stellar_area_factor).
        u1, u2 = R.uniform_n(keys, counter, 2, dtype)
        counter = counter + 2
        if static.crescent:
            # crescent sampling r > 0.9 by inverse transform (:1041-1049)
            u1 = 0.81 + 0.19 * u1
        r_disk = jnp.sqrt(u1)
        phi_disk = TWO_PI * u2
        disk1 = r_disk * jnp.sin(phi_disk)
        disk2 = r_disk * jnp.cos(phi_disk)
        depth = jnp.sqrt(jnp.maximum(1.0 - disk1 * disk1 - disk2 * disk2, 0.0))

        if static.stellar_direction:
            rot_y = M.rotation_matrix(1, -(PI / 2.0 - t.star_theta))
            rot_z = M.rotation_matrix(2, t.star_phi)
            rot = jnp.matmul(rot_z, rot_y, precision=jax.lax.Precision.HIGHEST)
            # columns of rot: the images of -x, y, z
            u_hat = -rot[:, 0].astype(dtype)
            e1 = rot[:, 1].astype(dtype)
            e2 = rot[:, 2].astype(dtype)
        else:
            u_hat = jnp.asarray([-1.0, 0.0, 0.0], dtype)
            e1 = jnp.asarray([0.0, 1.0, 0.0], dtype)
            e2 = jnp.asarray([0.0, 0.0, 1.0], dtype)

        s_diag = jnp.asarray([grid.ob_ax, grid.ob_by, grid.ob_cz], dtype)
        w = s_diag * u_hat
        w_hat = w / jnp.linalg.norm(w)
        e1s = s_diag * e1
        e1s = e1s - jnp.sum(e1s * w_hat) * w_hat
        e1s = e1s / jnp.linalg.norm(e1s)
        e2s = jnp.cross(e1s, w_hat)
        q = (disk1[..., None] * e1s + disk2[..., None] * e2s
             - depth[..., None] * w_hat)
        pos = q / s_diag
        dirn = jnp.broadcast_to(u_hat, pos.shape)
        cell = G.locate_cell(grid, pos, jnp.full((n,), grid.nr - 1, jnp.int32))
        face = jnp.broadcast_to(jnp.asarray([1, grid.nr], jnp.int32), (n, 2))
        bias_weight = jnp.ones(n, dtype)
        return pos, dirn, cell, face, bias_weight, counter

    # thermal: sample cell from the cumulative-emissivity CDF (:1124-1155)
    u_cell, u_r, u_t, u_p, u_a, u_b = R.uniform_n(keys, counter, 6, dtype)
    counter = counter + 6
    # keep the birth point off the cell faces: f32 rounding snaps
    # r0 + u*dr onto the face for u < ~ulp(r0)/dr (measured 3e-5 of thermal
    # births erroring in their birth peel); the position bias is < 1e-4 of
    # the cell width
    u_r = jnp.clip(u_r, 1.0e-4, 1.0 - 1.0e-4)
    u_t = jnp.clip(u_t, 1.0e-4, 1.0 - 1.0e-4)
    total = t.emis_cum[-1]
    target = u_cell * total
    idx = jnp.searchsorted(t.emis_cum, target, side="left").astype(jnp.int32)
    idx = jnp.clip(idx, 0, t.emis_cum.shape[0] - 1)
    cr = idx // (grid.ntheta * grid.nphi)
    ct = (idx // grid.nphi) % grid.ntheta
    cp = idx % grid.nphi
    cell = jnp.stack([cr, ct, cp], axis=-1)

    r = grid.rfront[cr] + u_r * (grid.rfront[cr + 1] - grid.rfront[cr])
    cos_t = grid.theta_cos[ct] + u_t * (grid.theta_cos[ct + 1] - grid.theta_cos[ct])
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    if grid.nphi == 1:
        phi = TWO_PI * u_p
    else:
        phifront = jnp.arctan2(grid.phi_sin, grid.phi_cos)
        phifront = jnp.where(phifront < 0.0, phifront + TWO_PI, phifront)
        phi_lo = phifront[cp]
        phi_hi = jnp.where(cp == grid.nphi - 1, TWO_PI, phifront[jnp.minimum(cp + 1, grid.nphi - 1)])
        phi = phi_lo + u_p * (phi_hi - phi_lo)
    pos = jnp.stack([r * sin_t * jnp.cos(phi) / grid.ob_ax,
                     r * sin_t * jnp.sin(phi) / grid.ob_by,
                     r * cos_t / grid.ob_cz], axis=-1)

    if static.photon_emission == 1:
        # isotropic (:1212-1227)
        alpha = 2.0 * u_a - 1.0
        beta = TWO_PI * u_b
        s = jnp.sqrt(jnp.maximum(1.0 - alpha * alpha, 0.0))
        dirn = jnp.stack([s * jnp.cos(beta), s * jnp.sin(beta), alpha], axis=-1)
        bias_weight = jnp.ones(n, dtype)
    else:
        # biased upward, Gordon 1987 (:1229-1254)
        bias = t.photon_bias
        y_bias = (1.0 + bias) * jnp.tan(PI * u_a / 2.0) / jnp.sqrt(1.0 - bias * bias)
        theta_s = jnp.arccos(jnp.clip((1.0 - y_bias * y_bias) / (1.0 + y_bias * y_bias), -1.0, 1.0))
        beta = TWO_PI * u_b
        a2 = grid.ob_ax * grid.ob_ax
        b2 = grid.ob_by * grid.ob_by
        c2 = grid.ob_cz * grid.ob_cz
        radial_unit = jnp.stack([pos[..., 0] * a2, pos[..., 1] * b2, pos[..., 2] * c2], axis=-1)
        radial_unit = radial_unit / jnp.linalg.norm(radial_unit, axis=-1, keepdims=True)
        dirn = M.direction_cosine(jnp.cos(PI - theta_s), beta, radial_unit)
        bias_weight = (PI * jnp.sin(theta_s) * (1.0 + bias * jnp.cos(theta_s))) / \
            (2.0 * jnp.sqrt(1.0 - bias * bias))
    face = jnp.zeros((n, 2), jnp.int32)
    return pos, dirn, cell, face, bias_weight, counter


# ---------------------------------------------------------------------------
# Flow diagnostics (ARTES.f90:4992-5047): per-cell energy-transport tallies
# ---------------------------------------------------------------------------

def _flow_global_update(flow, grid, pos, dirn, energy, dist, cell_flat, mask):
    """Project direction onto local (r, theta, phi) unit vectors and book
    energy*distance into the cell (``add_flow_global`` ARTES.f90:4992-5014)."""
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    r = jnp.sqrt(x * x + y * y + z * z)
    theta = jnp.arccos(jnp.clip(z / jnp.maximum(r, 1e-300), -1.0, 1.0))
    phi = jnp.arctan2(y, x)
    st, ct = jnp.sin(theta), jnp.cos(theta)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    dx, dy, dz = dirn[..., 0], dirn[..., 1], dirn[..., 2]
    r_dir = st * cp * dx + st * sp * dy + ct * dz
    t_dir = ct * cp * dx + ct * sp * dy - st * dz
    p_dir = -sp * dx + cp * dy
    w = energy * dist * mask
    idx = jnp.where(mask, cell_flat, flow.shape[0])
    vals = jnp.stack([r_dir, t_dir, p_dir], axis=-1) * w[..., None]
    return flow.at[idx].add(vals, mode="drop")


def _flow_theta_update(flow, next_axis, outward, energy, cell_flat, mask):
    """Boundary-crossing tallies: 0 up, 1 down, 2 south, 3 north
    (``add_flow`` ARTES.f90:5016-5047, dispatch at :730-744)."""
    is_r = next_axis == 1
    is_t = next_axis == 2
    col = jnp.where(is_r, jnp.where(outward, 0, 1), jnp.where(outward, 2, 3))
    ok = mask & (is_r | is_t)
    idx = jnp.where(ok, cell_flat, flow.shape[0])
    return flow.at[idx, col].add(energy * ok, mode="drop")


# ---------------------------------------------------------------------------
# Transport march: walk to the next interaction point / exit / surface
# (the do-loops at ARTES.f90:687-778 and :850-941)
# ---------------------------------------------------------------------------

def _march_radial(t: TransportTables, static: KernelStatic, counter,
                  pos, dirn, cell, face, stokes, tau, active, detector,
                  flow_g, flow_t, merged_peel, peel_dir, peel_active):
    """Closed-form transport march for radial-only, surfaceless grids
    (transport/radial.py): no while_loop, no RNG sites consumed, no
    geometry failure modes. Output contract mirrors :func:`_march`."""
    grid = t.grid
    B = pos.shape[0]
    a2, b2, c2, rf, kx, rfl, peps = _radial_lists(t)

    flow_obj = None
    if static.track_flow:
        # closed-form flow booking (radial.py march flow hook): per
        # trace-time shell segment, .at[m].add of the lane-summed tallies
        class _FlowAcc:
            def __init__(self, fg, ft):
                self.fg = fg
                self.ft = ft

            def add_g(self, m, wr, wt, wp):
                self.fg = self.fg.at[m].add(jnp.stack(
                    [jnp.sum(wr, dtype=self.fg.dtype),
                     jnp.sum(wt, dtype=self.fg.dtype),
                     jnp.sum(wp, dtype=self.fg.dtype)]))

            def add_t(self, m, col, w):
                self.ft = self.ft.at[m, col].add(
                    jnp.sum(w, dtype=self.ft.dtype))

        flow_obj = _FlowAcc(flow_g, flow_t)

    mo = RAD.march(a2, b2, c2, rf, kx, rfl, peps,
                   pos[..., 0], pos[..., 1], pos[..., 2],
                   dirn[..., 0], dirn[..., 1], dirn[..., 2],
                   tau, active, jnp.int32,
                   energy=stokes[..., 0], flow=flow_obj)
    if flow_obj is not None:
        flow_g, flow_t = flow_obj.fg, flow_obj.ft
    moved = mo["inter"] | mo["surface"]
    pos_new = jnp.where(moved[..., None],
                        pos + mo["s_stop"][..., None] * dirn, pos)
    cell_new = jnp.where(mo["inter"][..., None],
                         jnp.stack([mo["cr"], jnp.zeros_like(mo["cr"]),
                                    jnp.zeros_like(mo["cr"])], axis=-1),
                         cell)
    face_new = jnp.where(mo["inter"][..., None], jnp.zeros_like(face), face)
    false = jnp.zeros(B, bool)
    out = {
        "pos": pos_new, "dirn": dirn, "cell": cell_new, "face": face_new,
        "stokes": stokes, "tau_run": mo["tau_surf"],
        "interacted": mo["inter"], "exited": mo["exited"],
        "absorbed": mo["surface"], "surface": mo["surface"],
        "error": false, "e031": false, "e032": false, "e034": false,
        "marching": false, "detector": detector,
        "flow_g": flow_g if flow_g is not None else jnp.zeros((1, 3), pos.dtype),
        "flow_t": flow_t if flow_t is not None else jnp.zeros((1, 4), pos.dtype),
        "counter": counter,
    }
    if merged_peel:
        pdir = jnp.broadcast_to(t.det_dir, (B, 3)).astype(dirn.dtype) \
            if peel_dir is None else peel_dir
        pw = RAD.tau_walk(a2, b2, c2, rf, kx, rfl, peps,
                          pos[..., 0], pos[..., 1], pos[..., 2],
                          pdir[..., 0], pdir[..., 1], pdir[..., 2])
        peel = {"tau": pw["tau"], "exited": pw["exited"],
                "surface": pw["surface"], "error": false}
        return out, counter, peel
    return out, counter


def _march(t: TransportTables, static: KernelStatic, keys, counter,
           pos, dirn, cell, face, stokes, tau, active, detector,
           flow_g=None, flow_t=None, merged_peel: bool = False,
           peel_dir=None, peel_active=None, _jumps: bool = True):
    """Walk to the next interaction point / exit / surface.

    With ``merged_peel`` the per-scatter detector peel walk rides along as a
    second half of the lane dimension (same start point, detector direction,
    no interactions/RNG): both walks advance concurrently, so the sequential
    while-loop depth per scatter round is max(len_peel, len_march) instead of
    their sum. The RNG site schedule is unchanged (draws use the first-half
    keys), keeping per-photon streams identical to the unmerged form.

    ``counter`` is a (B,) per-lane draw-site vector, so every photon's
    stream is a function of its own event history only — the one schedule
    shared by every kernel variant (single-device, sharded, vmapped,
    regeneration). The marching path advances it by 3 per crossing per lane
    (the in-march Lambert draws); the closed-form radial path
    (transport/radial.py, taken for radial surfaceless grids) consumes none.
    ``peel_dir`` overrides the peel half's direction per lane (default: the
    detector direction); ``peel_active`` masks the peel half separately
    (default: same as ``active``).
    """
    grid = t.grid
    B = pos.shape[0]
    if RAD.use_closed_form(grid, static):
        return _march_radial(t, static, counter, pos, dirn, cell, face,
                             stokes, tau, active, detector, flow_g, flow_t,
                             merged_peel, peel_dir, peel_active)
    if _jumps and _use_jumps(grid, static):
        # 3-D jump walks (transport/jumps.py): (1) exit-PRECHECK along the
        # transport direction — a lane whose sampled tau exceeds the exact
        # path total exits/absorbs WITHOUT marching, so the lockstep
        # while_loop below is bounded by interaction depths instead of the
        # grid diameter (escape marches crossed the whole grid); (2) the
        # detector/prewalk peel as a loop-free jump walk instead of the
        # merged second marching half.
        env = _jump_env(t)
        w = J.tau_walk_jumps(env, pos[..., 0], pos[..., 1], pos[..., 2],
                             dirn[..., 0], dirn[..., 1], dirn[..., 2],
                             cell[..., 0], cell[..., 1], cell[..., 2])
        no_reach = active & (tau >= w["tau"])
        out, counter = _march(t, static, keys, counter, pos, dirn, cell,
                              face, stokes, tau, active & ~no_reach,
                              detector, flow_g, flow_t, merged_peel=False,
                              _jumps=False)
        out["exited"] = out["exited"] | (no_reach & w["exited"])
        out["absorbed"] = out["absorbed"] | (no_reach & w["surface"])
        out["surface"] = out["surface"] | (no_reach & w["surface"])
        if not merged_peel:
            return out, counter
        pdir = jnp.broadcast_to(t.det_dir, (B, 3)).astype(dirn.dtype) \
            if peel_dir is None else peel_dir
        pw = J.tau_walk_jumps(env, pos[..., 0], pos[..., 1], pos[..., 2],
                              pdir[..., 0], pdir[..., 1], pdir[..., 2],
                              cell[..., 0], cell[..., 1], cell[..., 2])
        peel = {"tau": pw["tau"], "exited": pw["exited"],
                "surface": pw["surface"], "error": pw["err"]}
        return out, counter, peel
    if merged_peel:
        inf = jnp.asarray(jnp.inf, tau.dtype)
        pdir = jnp.broadcast_to(t.det_dir, (B, 3)).astype(dirn.dtype) \
            if peel_dir is None else peel_dir
        pact = active if peel_active is None else peel_active
        pos = jnp.concatenate([pos, pos])
        dirn = jnp.concatenate([dirn, pdir])
        cell = jnp.concatenate([cell, cell])
        face = jnp.concatenate([face, face])
        stokes = jnp.concatenate([stokes, stokes])
        tau = jnp.concatenate([tau, jnp.full((B,), inf, tau.dtype)])  # peel never interacts
        active = jnp.concatenate([active, pact])
        is_trans = jnp.concatenate([jnp.ones(B, bool), jnp.zeros(B, bool)])
    else:
        is_trans = jnp.ones(B, bool)

    def half_draw3(base_site):
        # draws belong to the transport half; the peel half never consumes
        us = R.uniform_n(keys, base_site, 3, stokes.dtype)
        if merged_peel:
            us = [jnp.concatenate([u, jnp.zeros_like(u)]) for u in us]
        return us

    def cond(c):
        return jnp.any(c["marching"]) & (c["it"] < static.max_crossings)

    def body(c):
        m = c["marching"]
        out = G.cell_face(grid, c["pos"], c["dirn"], c["cell"], c["face"], t.cell_depth)
        d = out["distance"]
        cfl = flat_cell(grid, c["cell"])
        k = G.gather_rows(t.opacity, cfl)
        tau_cell = d * k
        interact = is_trans & (c["tau_run"] + tau_cell > c["tau"])
        s_int = (c["tau"] - c["tau_run"]) / jnp.where(k == 0.0, 1.0, k)
        step = jnp.where(interact, s_int, d)
        pos_new = c["pos"] + step[..., None] * c["dirn"]

        if static.track_flow:
            # flow booked with the post-advance position, pre-update cell
            # (ARTES.f90:711-744)
            fg = _flow_global_update(c["flow_g"], grid, pos_new, c["dirn"],
                                     c["stokes"][..., 0], step, cfl, m & is_trans)
            outward = out["cell_out"][..., 0] > c["cell"][..., 0]
            outward = jnp.where(out["next_face"][..., 0] == 2,
                                out["cell_out"][..., 1] > c["cell"][..., 1], outward)
            ft = _flow_theta_update(c["flow_t"], out["next_face"][..., 0], outward,
                                    c["stokes"][..., 0], cfl, m & is_trans & ~interact)
        else:
            fg, ft = c["flow_g"], c["flow_t"]

        hit_surface = ~interact & (out["next_face"][..., 0] == 1) & \
            (out["next_face"][..., 1] == t.cell_depth)
        # peel lanes are blocked by the surface: stop, no reflection, no RNG
        peel_blocked = m & hit_surface & ~is_trans
        surface_flag = c["surface"] | peel_blocked | (m & hit_surface & is_trans)
        hit_surface = hit_surface & is_trans
        any_surface = jnp.any(m & hit_surface)

        # surface event: absorb or Lambertian-reflect (ARTES.f90:755-774).
        # The whole machinery (3 RNG draws, surface normal, reflection
        # direction, detector peel) is skipped when no lane is on the surface
        # this crossing — the common case for surfaceless/deep atmospheres.
        def surface_branch(ops):
            detector, stokes_in, dirn_in, cell_out_in = ops
            u_s, u_l1, u_l2 = half_draw3(c["counter"])
            absorbed_b = m & hit_surface & (u_s > t.surface_albedo)
            reflected = m & hit_surface & ~absorbed_b & ~out["error"]
            # Lambertian reflection direction (ARTES.f90:1369-1402)
            a2, b2, c2g = grid.ob_ax * grid.ob_ax, grid.ob_by * grid.ob_by, grid.ob_cz * grid.ob_cz
            normal = jnp.stack([pos_new[..., 0] * a2, pos_new[..., 1] * b2,
                                pos_new[..., 2] * c2g], axis=-1)
            normal = normal / jnp.maximum(jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-300)
            lam_dir = M.direction_cosine(jnp.sqrt(u_l1), TWO_PI * u_l2, normal)

            detector_new = jax.lax.cond(
                jnp.any(reflected),
                lambda det: _peel_surface(t, static, det, pos_new, cell_out_in,
                                          out["next_face"], stokes_in, reflected),
                lambda det: det, detector)

            stokes_new = jnp.where(
                reflected[..., None],
                jnp.stack([stokes_in[..., 0], jnp.zeros_like(u_s),
                           jnp.zeros_like(u_s), jnp.zeros_like(u_s)], axis=-1),
                stokes_in)
            dirn_new = jnp.where(reflected[..., None], lam_dir, dirn_in)
            # reflected photon re-enters the cell above the surface (:770)
            cell_after = jnp.where(reflected[..., None],
                                   cell_out_in.at[..., 0].add(1), cell_out_in)
            return detector_new, stokes_new, dirn_new, cell_after, absorbed_b

        def no_surface(ops):
            detector, stokes_in, dirn_in, cell_out_in = ops
            return (detector, stokes_in, dirn_in, cell_out_in,
                    jnp.zeros_like(hit_surface))

        detector_new, stokes_new, dirn_new, cell_after, absorbed = jax.lax.cond(
            any_surface, surface_branch, no_surface,
            (c["detector"], c["stokes"], c["dirn"], out["cell_out"]))

        crossing = m & ~interact
        stop_interact = m & interact
        exited = c["exited"] | (crossing & out["grid_exit"] & ~hit_surface)
        err = c["error"] | (m & out["error"])
        e031 = c["e031"] | (m & out["err_nocand"])
        e034 = c["e034"] | (m & out["err_degen"])
        still = crossing & ~out["grid_exit"] & ~absorbed & ~err & ~peel_blocked

        adv = (m & is_trans)[:B] if merged_peel else (m & is_trans)
        counter_new = c["counter"] + 3 * adv.astype(c["counter"].dtype)

        return {
            "pos": jnp.where(m[..., None], pos_new, c["pos"]),
            "dirn": jnp.where(m[..., None], dirn_new, c["dirn"]),
            "cell": jnp.where(crossing[..., None], cell_after, c["cell"]),
            "face": jnp.where(crossing[..., None], out["next_face"],
                              jnp.where(stop_interact[..., None],
                                        jnp.zeros_like(c["face"]), c["face"])),
            "stokes": jnp.where(m[..., None], stokes_new, c["stokes"]),
            "tau_run": c["tau_run"] + jnp.where(crossing, tau_cell, 0.0),
            "tau": c["tau"],
            "interacted": c["interacted"] | stop_interact,
            "exited": exited,
            "absorbed": c["absorbed"] | absorbed,
            "surface": surface_flag,
            "error": err,
            "e031": e031,
            "e034": e034,
            "marching": still,
            "detector": detector_new,
            "flow_g": fg,
            "flow_t": ft,
            "counter": counter_new,
            "it": c["it"] + 1,
        }

    init = {
        "pos": pos, "dirn": dirn, "cell": cell, "face": face, "stokes": stokes,
        "tau_run": jnp.zeros_like(tau), "tau": tau,
        "interacted": jnp.zeros(tau.shape, bool),
        "exited": jnp.zeros(tau.shape, bool),
        "absorbed": jnp.zeros(tau.shape, bool),
        "surface": jnp.zeros(tau.shape, bool),
        "error": jnp.zeros(tau.shape, bool),
        "e031": jnp.zeros(tau.shape, bool),
        "e034": jnp.zeros(tau.shape, bool),
        "marching": active,
        "detector": detector,
        "flow_g": flow_g if flow_g is not None else jnp.zeros((1, 3), pos.dtype),
        "flow_t": flow_t if flow_t is not None else jnp.zeros((1, 4), pos.dtype),
        "counter": counter,
        "it": jnp.asarray(0, jnp.int32),
    }
    out = jax.lax.while_loop(cond, body, init)
    # lanes still marching at the crossing cap are abandoned as errors
    # (code 032: runaway traversal)
    out["e032"] = out["marching"]
    out["error"] = out["error"] | out["marching"]
    final_counter = out["counter"]
    if merged_peel:
        peel = {
            "tau": out["tau_run"][B:],
            "exited": out["exited"][B:],
            "surface": out["surface"][B:],
            "error": out["error"][B:],
        }
        for key in ("pos", "dirn", "cell", "face", "stokes", "tau_run",
                    "interacted", "exited", "absorbed", "surface", "error",
                    "e031", "e032", "e034", "marching"):
            out[key] = out[key][:B]
        return out, final_counter, peel
    return out, final_counter


def _first_tau_walk(t: TransportTables, static: KernelStatic, pos, dirn, cell, face, active):
    """Pre-walk to the grid edge/surface accumulating tau_first
    (ARTES.f90:623-656)."""
    grid = t.grid
    if _use_jumps(grid, static):
        env = _jump_env(t)
        o = J.tau_walk_jumps(env, pos[..., 0], pos[..., 1], pos[..., 2],
                             dirn[..., 0], dirn[..., 1], dirn[..., 2],
                             cell[..., 0], cell[..., 1], cell[..., 2])
        return o["tau"], o["surface"], o["err"]
    if RAD.use_closed_form(grid, static):
        a2, b2, c2, rf, kx, rfl, peps = _radial_lists(t)
        o = RAD.tau_walk(a2, b2, c2, rf, kx, rfl, peps,
                         pos[..., 0], pos[..., 1], pos[..., 2],
                         dirn[..., 0], dirn[..., 1], dirn[..., 2])
        return o["tau"], o["surface"], o["err"]

    def cond(c):
        return jnp.any(c["marching"]) & (c["it"] < static.max_crossings)

    def body(c):
        out = G.cell_face(grid, c["pos"], dirn, c["cell"], c["face"], t.cell_depth)
        d = out["distance"]
        tau_cell = d * G.gather_rows(t.opacity, flat_cell(grid, c["cell"]))
        m = c["marching"]
        hit_surface = (out["next_face"][..., 0] == 1) & (out["next_face"][..., 1] == t.cell_depth)
        stop = out["grid_exit"] | out["error"] | hit_surface
        return {
            "pos": jnp.where(m[..., None], c["pos"] + d[..., None] * dirn, c["pos"]),
            "cell": jnp.where(m[..., None], out["cell_out"], c["cell"]),
            "face": jnp.where(m[..., None], out["next_face"], c["face"]),
            "tau": c["tau"] + jnp.where(m, tau_cell, 0.0),
            "surface": c["surface"] | (m & hit_surface),
            "error": c["error"] | (m & out["error"]),
            "marching": m & ~stop,
            "it": c["it"] + 1,
        }

    init = {
        "pos": pos, "cell": cell, "face": face,
        "tau": jnp.zeros(pos.shape[:-1], pos.dtype),
        "surface": jnp.zeros(pos.shape[:-1], bool),
        "error": jnp.zeros(pos.shape[:-1], bool),
        "marching": active,
        "it": jnp.asarray(0, jnp.int32),
    }
    out = jax.lax.while_loop(cond, body, init)
    return out["tau"], out["surface"], out["error"]


# ---------------------------------------------------------------------------
# The full batch kernel
# ---------------------------------------------------------------------------

def _start_impl(t: TransportTables, static: KernelStatic, photon_ids, seed):
    """Emission + birth peel + forced first interaction + first march.

    Returns (state, out): ``state`` is the resumable per-photon state consumed
    by :func:`_scatter_rounds_impl`; ``out`` holds the tallies accumulated so
    far.
    """
    dtype = t.opacity.dtype
    n = photon_ids.shape[0]
    keys = R.photon_keys(seed, photon_ids)
    counter = jnp.asarray(0, jnp.uint32)

    det_dtype = jnp.float64 if static.det_f64 else dtype
    detector = jnp.zeros((static.nx * static.ny, 4, 3), det_dtype)

    pos, dirn, cell, face, bias_weight, counter = _emit(t, static, keys, counter, dtype)
    stokes = jnp.zeros((n, 4), dtype).at[:, 0].set(1.0)
    active = jnp.ones(n, bool)

    flux_emitted = jnp.zeros((), dtype)
    birth_err_mask = jnp.zeros(n, bool)
    if static.photon_source == 2:
        # thermal birth: weight + birth peel (ARTES.f90:599-621)
        w = bias_weight / G.gather_rows(t.cell_weight, flat_cell(t.grid, cell))
        stokes = stokes.at[:, 0].multiply(w)
        flux_emitted = jnp.sum(stokes[:, 0])
        detector, birth_err_mask = _peel_thermal(t, static, detector, pos, cell, face, stokes, active)
        active = active & ~birth_err_mask

    # forced first interaction (ARTES.f90:623-685)
    tau_first, surface_hit, pre_err = _first_tau_walk(t, static, pos, dirn, cell, face, active)
    active = active & ~pre_err
    u_tau = R.uniform(keys, counter, dtype)
    # per-lane draw-site counters from here on: every later draw site is a
    # function of the photon's own event history only (cross-kernel parity)
    counter = jnp.broadcast_to(jnp.asarray(counter + 1, jnp.uint32), (n,))
    thin = tau_first < 1.0e-6
    # photons through vacuum that do not hit the surface are dropped (:660-664)
    active = active & ~(thin & ~surface_hit)
    forced = (~thin) & (tau_first < 50.0)
    one_m_exp = 1.0 - jnp.exp(-tau_first)
    tau = jnp.where(forced,
                    -jnp.log(1.0 - u_tau * one_m_exp),
                    -jnp.log(1.0 - u_tau))
    stokes = jnp.where(forced[..., None], stokes * one_m_exp[..., None], stokes)

    ncell_flow = t.opacity.shape[0] if static.track_flow else 1
    flow_g = jnp.zeros((ncell_flow, 3), dtype)
    flow_t = jnp.zeros((ncell_flow, 4), dtype)
    m_out, counter = _march(t, static, keys, counter, pos, dirn, cell, face,
                            stokes, tau, active, detector, flow_g, flow_t)
    detector = m_out["detector"]
    flow_g, flow_t = m_out["flow_g"], m_out["flow_t"]
    pos, dirn, cell, face, stokes = (m_out["pos"], m_out["dirn"], m_out["cell"],
                                     m_out["face"], m_out["stokes"])
    flux_exit = jnp.zeros((), dtype)
    if static.photon_source == 2:
        flux_exit = flux_exit + jnp.sum(jnp.where(m_out["exited"] & active, stokes[:, 0], 0.0))
    n_error = jnp.sum(m_out["error"] & active, dtype=jnp.int32)
    # per-code tallies (reference error codes, ARTES.f90:3397-3416):
    # [031 no-candidate geometry, 032 crossing-cap runaway, 034 degenerate
    # surface bounce, peel-walk errors (flux silently dropped)]
    error_codes = jnp.stack([
        jnp.sum(m_out["e031"] & active, dtype=jnp.int32)
        + jnp.sum(pre_err, dtype=jnp.int32),
        jnp.sum(m_out["e032"] & active, dtype=jnp.int32),
        jnp.sum(m_out["e034"] & active, dtype=jnp.int32),
        jnp.sum(birth_err_mask, dtype=jnp.int32),
    ])
    alive = active & m_out["interacted"] & ~m_out["error"]

    state = {
        "pos": pos, "dirn": dirn, "cell": cell, "face": face, "stokes": stokes,
        "alive": alive, "counter": counter, "photon_ids": photon_ids,
    }
    out = {
        "detector": detector, "flow_global": flow_g, "flow_theta": flow_t,
        "flux_emitted": flux_emitted, "flux_exit": flux_exit,
        "n_error": n_error, "error_codes": error_codes,
    }
    return state, out


def _scatter_rounds_impl(t: TransportTables, static: KernelStatic, state, seed,
                         rounds: int, detector, flow_g, flow_t):
    """Run up to ``rounds`` scatter rounds from ``state`` (resumable)."""
    dtype = t.opacity.dtype
    keys = R.photon_keys(seed, state["photon_ids"])
    flux_exit = jnp.zeros((), dtype)
    n_error = jnp.zeros((), jnp.int32)
    error_codes = jnp.zeros(4, jnp.int32)
    pos, dirn, cell, face, stokes, alive, counter = (
        state["pos"], state["dirn"], state["cell"], state["face"],
        state["stokes"], state["alive"], state["counter"])

    # ---- scatter loop (ARTES.f90:786-951) ----
    if static.photon_scattering and rounds > 0:
        def s_cond(c):
            return jnp.any(c["alive"]) & (c["round"] < rounds)

        def s_body(c):
            alive = c["alive"]
            counter = c["counter"]
            stokes = c["stokes"]
            # heal (pos, cell) inconsistencies from f32 tangent-root error
            # before anything reads the cell (see geometry.heal_cell)
            cell_h = G.heal_cell(t.grid, c["pos"], c["cell"], alive)
            c = {**c, "cell": cell_h}
            # the round's five draws (sites counter..counter+4) in one batch:
            # roulette, beta x2, alpha, next optical depth
            u_r, u1, u2, u3, u_t2 = R.uniform_n(keys, counter, 5, dtype)
            counter = counter + 5
            # russian roulette (:793-807)
            killed = alive & (u_r < t.fstop)
            alive = alive & ~killed
            cf = flat_cell(t.grid, c["cell"])
            alb = G.gather_rows(t.albedo, cf)
            gamma = jnp.where((alb < 1.0) & (alb > 0.0), alb / (1.0 - t.fstop), 1.0)
            stokes = jnp.where(alive[..., None], stokes * gamma[..., None], stokes)
            # minimum-energy removal (:810-813)
            too_small = alive & (stokes[..., 0] <= t.photon_minimum)
            alive = alive & ~too_small

            # peel to detector (:815): the tau-independent pieces now; the
            # detector-ray optical depth rides along the transport march below
            peel_contrib, peel_pix = _peel_photon_prep(
                t, static, c["pos"], c["dirn"], c["cell"], stokes)

            # sample scattering angles (:819 -> 1534-1661)
            beta, c2b, s2b = S.sample_beta(G.gather_rows(t.p_int, cf), stokes, u1, u2)
            alpha, alpha_deg = S.sample_alpha(t.alpha_prefix, cf, stokes,
                                                    (c2b, s2b), u3)
            dir_new = M.direction_cosine(alpha, beta, c["dirn"])
            scatter = S.matrix_at_angle_deg(t.scatter_rows, cf, alpha_deg)
            stokes_new = M.polarization_rotation(alpha, beta, stokes, scatter,
                                                 c["dirn"], dir_new, peeling=False,
                                                 beta_trig=(c2b, s2b))
            stokes = jnp.where(alive[..., None], stokes_new, stokes)
            dirn = jnp.where(alive[..., None], dir_new, c["dirn"])

            # next optical depth + march (:845-941)
            tau = -jnp.log(1.0 - u_t2)
            m_out, counter, peel = _march(t, static, keys, counter, c["pos"], dirn,
                                          c["cell"], c["face"], stokes, tau, alive,
                                          c["detector"], c["flow_g"], c["flow_t"],
                                          merged_peel=True)
            detector = m_out["detector"]
            w_peel = jnp.exp(-jnp.minimum(peel["tau"], 500.0))
            ok_peel = alive & peel["exited"] & (peel["tau"] < 50.0) & ~peel["error"]
            detector = _splat(detector, peel_pix, peel_contrib * w_peel[..., None],
                              ok_peel)
            flux_exit = c["flux_exit"]
            if static.photon_source == 2:
                flux_exit = flux_exit + jnp.sum(
                    jnp.where(m_out["exited"] & alive, m_out["stokes"][:, 0], 0.0))
            n_error = c["n_error"] + jnp.sum(m_out["error"] & alive, dtype=jnp.int32)
            error_codes = c["error_codes"] + jnp.stack([
                jnp.sum(m_out["e031"] & alive, dtype=jnp.int32),
                jnp.sum(m_out["e032"] & alive, dtype=jnp.int32),
                jnp.sum(m_out["e034"] & alive, dtype=jnp.int32),
                jnp.sum(peel["error"] & alive, dtype=jnp.int32)])
            alive = alive & m_out["interacted"] & ~m_out["error"]
            return {
                "pos": m_out["pos"], "dirn": m_out["dirn"], "cell": m_out["cell"],
                "face": m_out["face"], "stokes": m_out["stokes"],
                "alive": alive, "detector": detector,
                "flow_g": m_out["flow_g"], "flow_t": m_out["flow_t"],
                "flux_exit": flux_exit, "n_error": n_error,
                "error_codes": error_codes,
                "counter": counter, "round": c["round"] + 1,
            }

        carry = {
            "pos": pos, "dirn": dirn, "cell": cell, "face": face, "stokes": stokes,
            "alive": alive, "detector": detector, "flow_g": flow_g, "flow_t": flow_t,
            "flux_exit": flux_exit,
            "n_error": n_error, "error_codes": jnp.zeros(4, jnp.int32),
            "counter": counter,
            "round": jnp.asarray(0, jnp.int32),
        }
        carry = jax.lax.while_loop(s_cond, s_body, carry)
        detector = carry["detector"]
        flow_g, flow_t = carry["flow_g"], carry["flow_t"]
        flux_exit = carry["flux_exit"]
        n_error = carry["n_error"]
        error_codes = carry["error_codes"]
        pos, dirn, cell, face, stokes, alive, counter = (
            carry["pos"], carry["dirn"], carry["cell"], carry["face"],
            carry["stokes"], carry["alive"], carry["counter"])

    state_out = {
        "pos": pos, "dirn": dirn, "cell": cell, "face": face, "stokes": stokes,
        "alive": alive, "counter": counter, "photon_ids": state["photon_ids"],
    }
    out = {
        "detector": detector,
        "flow_global": flow_g,
        "flow_theta": flow_t,
        "flux_exit": flux_exit,
        "n_error": n_error,
        "error_codes": error_codes,
        "n_alive_at_cap": jnp.sum(alive, dtype=jnp.int32),
    }
    return state_out, out


@partial(jax.jit, static_argnums=(1,))
def start_batch(tables: TransportTables, static: KernelStatic, photon_ids, seed):
    """Jitted emission + first-interaction phase (resumable-state API)."""
    return _start_impl(tables, static, photon_ids, seed)


@partial(jax.jit, static_argnums=(1,))
def run_batch(tables: TransportTables, static: KernelStatic, photon_ids, seed):
    """Transport one batch of photons; returns detector sums + energy tallies.

    ``photon_ids``: (B,) global photon indices (determinism + device sharding).
    Returns dict: detector (nx*ny, 4, 3), flux_emitted, flux_exit, n_error,
    n_alive_at_cap.
    """
    state, out0 = _start_impl(tables, static, photon_ids, seed)
    _, out1 = _scatter_rounds_impl(
        tables, static, state, seed, static.max_scatter,
        out0["detector"], out0["flow_global"], out0["flow_theta"])
    return {
        "detector": out1["detector"],
        "flow_global": out1["flow_global"],
        "flow_theta": out1["flow_theta"],
        "flux_emitted": out0["flux_emitted"],
        "flux_exit": out0["flux_exit"] + out1["flux_exit"],
        "n_error": out0["n_error"] + out1["n_error"],
        "error_codes": out0["error_codes"] + out1["error_codes"],
        "n_alive_at_cap": out1["n_alive_at_cap"],
    }


# ---------------------------------------------------------------------------
# Regeneration kernel: fixed-width lane pool with in-loop refill
# ---------------------------------------------------------------------------
#
# The ``while any(alive)`` tail of run_batch means a handful of deep-diffusing
# photons keep the full batch width busy (measured: after 32 of 128 scatter
# rounds only 6 % of lanes are alive, yet every round costs full width). The
# reference hides the same tail behind per-photon OpenMP scheduling
# (ARTES.f90:534-546). Here the vectorised equivalent is *regeneration*: a
# fixed-width pool where dead lanes are refilled with freshly emitted photons
# inside the device loop, keeping occupancy near 100 % with no host syncs and
# no shape changes. Each lane cycles through stages:
#
#   DEAD -> [BIRTH_PEEL (thermal)] -> PREWALK -> FIRST_WALK -> LIVE* -> DEAD
#
# PREWALK runs the forced-first-interaction tau walk (ARTES.f90:623-656) in
# the march's *peel half* (it is exactly a tau-accumulating walk), so the
# transport half state is untouched; FIRST_WALK samples the forced optical
# depth (:675-684) and does the first transport march; LIVE rounds are the
# scatter loop (:786-951). RNG uses per-lane draw counters, so every photon's
# stream is a function of its own event history only — deterministic for a
# given (seed, photon id) regardless of lane placement, width, or device.

STAGE_DEAD = 0
STAGE_BIRTH_PEEL = 1
STAGE_PREWALK = 2
STAGE_FIRST_WALK = 3
STAGE_LIVE = 4


def _stream_impl(t: TransportTables, static: KernelStatic, n_photons, seed,
                 width: int, id_hi=0, id_lo=0):
    dtype = t.opacity.dtype
    W = width
    grid = t.grid
    thermal = static.photon_source == 2
    u32 = jnp.uint32
    fresh_stage = STAGE_BIRTH_PEEL if thermal else STAGE_PREWALK
    # loop-free walks (closed-form radial OR 3-D jump walks): the prewalk
    # fuses into the refill round (see the FUSED block in body),
    # shortening photon lifetime by one pool round
    fused = RAD.use_closed_form(t.grid, static) or _use_jumps(t.grid, static)

    ncell_flow = t.opacity.shape[0] if static.track_flow else 1
    n_photons = jnp.asarray(n_photons, u32)
    # runaway guard only; real termination is "all photons emitted and dead"
    round_cap = (n_photons // u32(W) + u32(2)) * u32(static.max_scatter + 4)

    # error forensics: state dump of the first ERR_RECORD_K error events
    # (the reference writes position/direction/cell per geometry failure,
    # ARTES.f90:3397-3416). One record per round at most — error rounds are
    # rare and the capture branch only executes on them (lax.cond).
    erK = ERR_RECORD_K

    det_dir_b = jnp.broadcast_to(t.det_dir, (W, 3)).astype(dtype)

    def cond(c):
        return ((c["n_emitted"] < n_photons) | jnp.any(c["stage"] != STAGE_DEAD)) \
            & (c["round"] < round_cap)

    def body(c):
        stage = c["stage"]
        pos, dirn, cell, face, stokes = (c["pos"], c["dirn"], c["cell"],
                                         c["face"], c["stokes"])
        counter, pid = c["counter"], c["pid"]
        tau_first, pre_surface = c["tau_first"], c["pre_surface"]
        n_scat = c["n_scat"]
        detector = c["detector"]
        n_error = c["n_error"]
        flux_emitted, flux_exit = c["flux_emitted"], c["flux_exit"]

        # ---- refill dead lanes with fresh photons ----
        dead = stage == STAGE_DEAD
        remaining = n_photons - c["n_emitted"]
        rank = jnp.cumsum(dead.astype(jnp.int32)) - 1
        refill = dead & (rank.astype(u32) < remaining)
        # pid is the LOW word of the photon's 64-bit global id; the chunk
        # base (id_hi, id_lo) comes from the caller, chunks never straddle a
        # 2^32 boundary (runner aligns them), so no in-kernel carry
        pid = jnp.where(refill,
                        jnp.asarray(id_lo, u32) + c["n_emitted"]
                        + rank.astype(u32), pid)
        n_emitted = c["n_emitted"] + jnp.sum(refill, dtype=u32)
        keys = R.photon_keys(seed, pid, id_hi)

        e_pos, e_dir, e_cell, e_face, e_bias, e_counter = _emit(
            t, static, keys, u32(0), dtype)
        if thermal:
            w0 = e_bias / G.gather_rows(t.cell_weight, flat_cell(grid, e_cell))
            flux_emitted = flux_emitted + jnp.sum(jnp.where(refill, w0, 0.0))
        else:
            w0 = jnp.ones(W, dtype)
        e_stokes = jnp.zeros((W, 4), dtype).at[:, 0].set(w0)
        rf = refill[:, None]
        pos = jnp.where(rf, e_pos, pos)
        dirn = jnp.where(rf, e_dir, dirn)
        cell = jnp.where(rf, e_cell, cell)
        face = jnp.where(rf, e_face, face)
        stokes = jnp.where(rf, e_stokes, stokes)
        counter = jnp.where(refill, jnp.broadcast_to(e_counter, (W,)), counter)
        tau_first = jnp.where(refill, 0.0, tau_first)
        pre_surface = jnp.where(refill, False, pre_surface)
        n_scat = jnp.where(refill, 0, n_scat)
        stage = jnp.where(refill, fresh_stage, stage)

        live = stage == STAGE_LIVE
        fw = stage == STAGE_FIRST_WALK
        nb1 = stage == STAGE_PREWALK
        nb0 = stage == STAGE_BIRTH_PEEL

        # heal (pos, cell) inconsistencies from f32 tangent-root error before
        # anything reads the cell (see geometry.heal_cell)
        cell = G.heal_cell(grid, pos, cell, live)

        # the round's draws (sites counter..counter+4) in one batch; FIRST_WALK
        # lanes use site counter+0 for their forced optical depth instead
        d0, d1, d2, d3, d4 = R.uniform_n(keys, counter, 5, dtype)

        # ---- LIVE: roulette + reweight + minimum (ARTES.f90:793-813) ----
        u_r = d0
        killed = live & (u_r < t.fstop)
        cf = flat_cell(grid, cell)
        alb = G.gather_rows(t.albedo, cf)
        gamma = jnp.where((alb < 1.0) & (alb > 0.0), alb / (1.0 - t.fstop), 1.0)
        stokes = jnp.where((live & ~killed)[:, None], stokes * gamma[:, None], stokes)
        too_small = live & ~killed & (stokes[..., 0] <= t.photon_minimum)
        live_surv = live & ~killed & ~too_small
        stage = jnp.where(killed | too_small, STAGE_DEAD, stage)

        # ---- LIVE: detector peel prep + scattering (:815-843) ----
        peel_contrib, peel_pix = _peel_photon_prep(t, static, pos, dirn, cell, stokes)
        u1, u2, u3 = d1, d2, d3
        beta, c2b, s2b = S.sample_beta(G.gather_rows(t.p_int, cf), stokes, u1, u2)
        alpha, alpha_deg = S.sample_alpha(t.alpha_prefix, cf, stokes,
                                                (c2b, s2b), u3)
        dir_new = M.direction_cosine(alpha, beta, dirn)
        scat_m = S.matrix_at_angle_deg(t.scatter_rows, cf, alpha_deg)
        stokes_new = M.polarization_rotation(alpha, beta, stokes, scat_m,
                                             dirn, dir_new, peeling=False,
                                             beta_trig=(c2b, s2b))
        lsv = live_surv[:, None]
        stokes = jnp.where(lsv, stokes_new, stokes)
        dirn_t = jnp.where(lsv, dir_new, dirn)
        if static.debug_stokes:
            # error 050 (ARTES.f90:830-835): I^2 < Q^2+U^2+V^2 after the
            # Mueller update is an unphysical polarization state — abandon
            # the photon (the reference also abandons it: sets cell_error
            # and exits the scattering loop) and tally separately
            anom = live_surv & (stokes[:, 0] ** 2 * (1.0 + 1.0e-6)
                                < jnp.sum(stokes[:, 1:] ** 2, axis=-1))
            n_anom = c["n_stokes_anomaly"] + jnp.sum(anom, dtype=jnp.int32)
            n_error = n_error + jnp.sum(anom, dtype=jnp.int32)
            live_surv = live_surv & ~anom
            stage = jnp.where(anom, STAGE_DEAD, stage)
        else:
            anom = None
            n_anom = c["n_stokes_anomaly"]
        n_scat = n_scat + live_surv.astype(jnp.int32)
        # run-wide scatter tally as a (hi, lo) uint32 pair: a 2^30-photon
        # chunk can scatter more than 2^32 times
        inc = jnp.sum(live_surv, dtype=u32)
        lo = c["n_scatter"][1] + inc
        n_scatter = jnp.stack([c["n_scatter"][0] + (lo < inc).astype(u32), lo])

        # ---- FUSED prewalk (closed-form radial only): the tau walk
        # resolves the fresh lanes' prewalk IN THIS ROUND, so they march
        # their forced first interaction immediately — photon lifetime
        # drops from 2+n_scat to 1+n_scat pool rounds. The draw-site
        # mapping is unchanged (the forced-tau site is consumed one round
        # earlier at the same site index). ----
        if fused:
            peel_dir = jnp.where(nb1[:, None], dirn, det_dir_b)
            if _use_jumps(t.grid, static):
                pw = J.tau_walk_jumps(
                    _jump_env(t), pos[..., 0], pos[..., 1], pos[..., 2],
                    peel_dir[..., 0], peel_dir[..., 1], peel_dir[..., 2],
                    cell[..., 0], cell[..., 1], cell[..., 2])
            else:
                a2_, b2_, c2_, rf_, kx_, rfl_, peps_ = _radial_lists(t)
                pw = RAD.tau_walk(a2_, b2_, c2_, rf_, kx_, rfl_, peps_,
                                  pos[..., 0], pos[..., 1], pos[..., 2],
                                  peel_dir[..., 0], peel_dir[..., 1],
                                  peel_dir[..., 2])
            peel = {"tau": pw["tau"], "exited": pw["exited"],
                    "surface": pw["surface"], "error": pw["err"]}
            tau_first = jnp.where(nb1, peel["tau"], tau_first)
            pre_surface = jnp.where(nb1, peel["surface"], pre_surface)
            fwx = fw | nb1
        else:
            fwx = fw

        # ---- optical depth: sampled (LIVE) or forced-first (FIRST_WALK,
        # ARTES.f90:675-684) ----
        u_tau = jnp.where(live, d4, d0)
        thin = tau_first < 1.0e-6
        fw_drop = fwx & thin & ~pre_surface     # vacuum, no surface (:660-664)
        stage = jnp.where(fw_drop, STAGE_DEAD, stage)
        fw_go = fwx & ~fw_drop
        forced = fw_go & ~thin & (tau_first < 50.0)
        one_m_exp = 1.0 - jnp.exp(-tau_first)
        tau = jnp.where(forced,
                        -jnp.log(1.0 - u_tau * one_m_exp),
                        -jnp.log(1.0 - u_tau))
        stokes = jnp.where(forced[:, None], stokes * one_m_exp[:, None], stokes)
        counter = counter + jnp.where(live, u32(5), u32(0)) \
            + jnp.where(fwx, u32(1), u32(0))

        # ---- merged march: transport half = LIVE/FIRST_WALK lanes; peel
        # half = scatter peel (LIVE), birth peel (BIRTH_PEEL), forced-first
        # prewalk (PREWALK, along the photon direction) ----
        active_t = live_surv | fw_go
        if fused:
            m_out, counter = _march(
                t, static, keys, counter, pos, dirn_t, cell, face, stokes,
                tau, active_t, detector, c["flow_g"], c["flow_t"])
        else:
            peel_active = live_surv | nb0 | nb1
            peel_dir = jnp.where(nb1[:, None], dirn, det_dir_b)
            m_out, counter, peel = _march(
                t, static, keys, counter, pos, dirn_t, cell, face, stokes,
                tau, active_t, detector, c["flow_g"], c["flow_t"],
                merged_peel=True, peel_dir=peel_dir, peel_active=peel_active)
        detector = m_out["detector"]

        # scatter peel splat (ARTES.f90:4945-4984)
        w_peel = jnp.exp(-jnp.minimum(peel["tau"], 500.0))
        ok_peel = live_surv & peel["exited"] & (peel["tau"] < 50.0) & ~peel["error"]
        detector = _splat(detector, peel_pix,
                          peel_contrib * w_peel[:, None], ok_peel)

        error_codes = c["error_codes"]
        if thermal:
            # birth peel splat, e^-tau/(4 pi) on Stokes I (ARTES.f90:4519-4598)
            w_b = w_peel / (4.0 * PI)
            ok_b = nb0 & peel["exited"] & (peel["tau"] < 50.0) & ~peel["error"]
            contrib_b = jnp.zeros((W, 4), dtype).at[:, 0].set(w_b * stokes[:, 0])
            pix_b = _pixel_index(t, static, pos)
            detector = _splat(detector, pix_b, contrib_b, ok_b, first_only=True)
            nb0_err = nb0 & peel["error"]
            n_error = n_error + jnp.sum(nb0_err, dtype=jnp.int32)
            error_codes = error_codes.at[3].add(jnp.sum(nb0_err, dtype=jnp.int32))
            stage = jnp.where(nb0_err, STAGE_DEAD,
                              jnp.where(nb0, STAGE_PREWALK, stage))

        # prewalk results -> FIRST_WALK (ARTES.f90:623-656); the fused path
        # already folded the prewalk into this round's forced march, so its
        # nb1 lanes transition through the generic outcome block below
        nb1_err = nb1 & peel["error"]
        n_error = n_error + jnp.sum(nb1_err, dtype=jnp.int32)
        if not fused:
            tau_first = jnp.where(nb1, peel["tau"], tau_first)
            pre_surface = jnp.where(nb1, peel["surface"], pre_surface)
            stage = jnp.where(nb1_err, STAGE_DEAD,
                              jnp.where(nb1, STAGE_FIRST_WALK, stage))

        # transport outcomes + per-code tallies (031/032/034/peel)
        terr = m_out["error"] & active_t
        n_error = n_error + jnp.sum(terr, dtype=jnp.int32)
        error_codes = error_codes + jnp.stack([
            jnp.sum(m_out["e031"] & active_t, dtype=jnp.int32)
            + jnp.sum(nb1_err, dtype=jnp.int32),
            jnp.sum(m_out["e032"] & active_t, dtype=jnp.int32),
            jnp.sum(m_out["e034"] & active_t, dtype=jnp.int32),
            jnp.sum(peel["error"] & live_surv, dtype=jnp.int32)])

        # ---- error forensics, first-K + last-K ring (ARTES.f90:3397-3416;
        # the reference appends EVERY failure up to a 100 MB log — here the
        # first K records plus a ring of the K most recent, so late-run
        # failures of a long job are captured too) ----
        peel_err = peel["error"] & live_surv
        any_err = terr | nb1_err | peel_err
        if static.debug_stokes:
            any_err = any_err | anom

        def capture(ops):
            rec, n_rec = ops
            lane = jnp.argmax(any_err)
            code = jnp.where(terr[lane],
                             jnp.where(m_out["e031"][lane], 31.0,
                                       jnp.where(m_out["e034"][lane], 34.0,
                                                 32.0)),
                             jnp.where(nb1_err[lane], 31.0, 50.0))
            site = jnp.where(terr[lane], jnp.where(fw[lane], 1.0, 0.0),
                             jnp.where(nb1_err[lane], 2.0, 3.0))
            if static.debug_stokes:
                code = jnp.where(anom[lane] & ~terr[lane] & ~nb1_err[lane]
                                 & ~peel_err[lane], 50.0, code)
                site = jnp.where(anom[lane] & ~terr[lane] & ~nb1_err[lane]
                                 & ~peel_err[lane], 4.0, site)
            fdt = rec.dtype
            # transport errors dump the post-march state (where the walk
            # failed); peel/prewalk errors dump the walk's INPUT state (the
            # scatter position the failing walk started from)
            tl = terr[lane]

            def sel(post, pre):
                return jnp.where(tl, post[lane].astype(fdt),
                                 pre[lane].astype(fdt))

            row = jnp.stack([
                code, pid[lane].astype(fdt),
                sel(m_out["pos"][:, 0], pos[:, 0]),
                sel(m_out["pos"][:, 1], pos[:, 1]),
                sel(m_out["pos"][:, 2], pos[:, 2]),
                m_out["dirn"][lane, 0].astype(fdt),
                m_out["dirn"][lane, 1].astype(fdt),
                m_out["dirn"][lane, 2].astype(fdt),
                sel(m_out["cell"][:, 0], cell[:, 0]),
                sel(m_out["cell"][:, 1], cell[:, 1]),
                sel(m_out["cell"][:, 2], cell[:, 2]),
                sel(m_out["face"][:, 0], face[:, 0]),
                sel(m_out["face"][:, 1], face[:, 1]),
                m_out["stokes"][lane, 0].astype(fdt),
                n_scat[lane].astype(fdt), site])
            # rows [0, K): first K events; rows [K, 2K): ring of the latest
            slot = jnp.where(n_rec < erK, n_rec, erK + n_rec % erK)
            rec = jax.lax.dynamic_update_slice(
                rec, row[None], (slot, jnp.zeros((), n_rec.dtype)))
            return rec, n_rec + 1

        err_rec, n_err_rec = jax.lax.cond(
            jnp.any(any_err),
            capture, lambda ops: ops, (c["err_rec"], c["n_err_rec"]))
        if thermal:
            flux_exit = flux_exit + jnp.sum(
                jnp.where(m_out["exited"] & active_t, m_out["stokes"][:, 0], 0.0))
        to_live = active_t & m_out["interacted"] & ~m_out["error"]
        if not static.photon_scattering:
            to_live = jnp.zeros_like(to_live)
        stage = jnp.where(active_t,
                          jnp.where(to_live, STAGE_LIVE, STAGE_DEAD), stage)
        capped = (stage == STAGE_LIVE) & (n_scat >= static.max_scatter)
        n_cap = c["n_alive_at_cap"] + jnp.sum(capped, dtype=jnp.int32)
        stage = jnp.where(capped, STAGE_DEAD, stage)

        out = {
            "stage": stage, "pid": pid, "counter": counter,
            "pos": m_out["pos"], "dirn": m_out["dirn"], "cell": m_out["cell"],
            "face": m_out["face"], "stokes": m_out["stokes"],
            "tau_first": tau_first, "pre_surface": pre_surface,
            "n_scat": n_scat, "n_emitted": n_emitted,
            "detector": detector, "flow_g": m_out["flow_g"],
            "flow_t": m_out["flow_t"],
            "flux_emitted": flux_emitted, "flux_exit": flux_exit,
            "n_error": n_error, "error_codes": error_codes,
            "n_alive_at_cap": n_cap,
            "n_stokes_anomaly": n_anom,
            "n_scatter": n_scatter,
            "round": c["round"] + u32(1),
        }
        out["err_rec"] = err_rec
        out["n_err_rec"] = n_err_rec
        return out

    init = {
        "stage": jnp.zeros(W, jnp.int32),
        "pid": jnp.zeros(W, u32),
        "counter": jnp.zeros(W, u32),
        "pos": jnp.zeros((W, 3), dtype),
        "dirn": jnp.tile(jnp.asarray([1.0, 0.0, 0.0], dtype), (W, 1)),
        "cell": jnp.zeros((W, 3), jnp.int32),
        "face": jnp.zeros((W, 2), jnp.int32),
        "stokes": jnp.zeros((W, 4), dtype),
        "tau_first": jnp.zeros(W, dtype),
        "pre_surface": jnp.zeros(W, bool),
        "n_scat": jnp.zeros(W, jnp.int32),
        "n_emitted": u32(0),
        "detector": jnp.zeros((static.nx * static.ny, 4, 3),
                              jnp.float64 if static.det_f64 else dtype),
        "flow_g": jnp.zeros((ncell_flow, 3), dtype),
        "flow_t": jnp.zeros((ncell_flow, 4), dtype),
        "flux_emitted": jnp.zeros((), dtype),
        "flux_exit": jnp.zeros((), dtype),
        "n_error": jnp.zeros((), jnp.int32),
        "error_codes": jnp.zeros(4, jnp.int32),
        "n_alive_at_cap": jnp.zeros((), jnp.int32),
        "round": u32(0),
    }
    init["err_rec"] = jnp.zeros((2 * ERR_RECORD_K, ERR_RECORD_W), dtype)
    init["n_err_rec"] = jnp.zeros((), jnp.int32)
    init["n_stokes_anomaly"] = jnp.zeros((), jnp.int32)
    init["n_scatter"] = jnp.zeros(2, u32)
    out = jax.lax.while_loop(cond, body, init)
    return {
        "detector": out["detector"],
        "error_records": out["err_rec"],
        "n_error_records": out["n_err_rec"],
        "flow_global": out["flow_g"],
        "flow_theta": out["flow_t"],
        "flux_emitted": out["flux_emitted"],
        "flux_exit": out["flux_exit"],
        "n_error": out["n_error"],
        "error_codes": out["error_codes"],
        "n_alive_at_cap": out["n_alive_at_cap"],
        "n_stokes_anomaly": out["n_stokes_anomaly"],
        "n_emitted": out["n_emitted"],
        "n_scatter": out["n_scatter"],
        "n_rounds": out["round"],
    }


def scatter_total(n_scatter) -> int:
    """Total scattering events from :func:`run_stream`'s (hi, lo) uint32
    ``n_scatter`` tally (or a stack of them, one per device)."""
    a = np.asarray(n_scatter, np.uint64).reshape(-1, 2)
    return int(a[:, 0].sum()) * (1 << 32) + int(a[:, 1].sum())


def order_error_records(rec, n, k=ERR_RECORD_K):
    """Chronological view of the first-K + last-K ring record buffer
    (see _stream_impl forensics): rows [0,K) hold the first K events, rows
    [K,2K) a ring of the most recent ones."""
    rec = np.asarray(rec)
    n = int(n)
    if n <= k:
        return rec[:n]
    m = min(k, n - k)
    ring = [rec[k + (i % k)] for i in range(n - m, n)]
    return np.concatenate([rec[:k], np.stack(ring)], axis=0)


@partial(jax.jit, static_argnums=(1, 4))
def run_stream(tables: TransportTables, static: KernelStatic, n_photons, seed,
               width: int, id_hi=0, id_lo=0):
    """Transport ``n_photons`` photons through a fixed ``width`` lane pool
    with in-loop regeneration (single device dispatch, no host syncs).

    ``n_photons`` is traced (no recompile per photon count); ``width`` is
    static. ``(id_hi, id_lo)`` is the 64-bit global id of the first photon
    (traced uint32 words); the chunk [id, id+n) must not straddle a 2^32
    boundary. Returns the same tallies as :func:`run_batch` plus
    ``n_emitted``, ``n_scatter`` (see :func:`scatter_total`) and
    ``n_rounds``.
    """
    return _stream_impl(tables, static, jnp.asarray(n_photons, jnp.uint32),
                        seed, width, jnp.asarray(id_hi, jnp.uint32),
                        jnp.asarray(id_lo, jnp.uint32))
