"""Order-free 3-D jump walks (transport/jumps.py) against a brute-force
numerical line integral of k over the cell structure.

The jump walk claims EXACTNESS (not an approximation): tau is a finite sum
of per-crossing jump terms, so agreement with a dense midpoint integration
of the same piecewise-constant opacity field is limited only by the
integration step of the reference."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from artes import presets
from artes.config import ArtesConfig, detector_setup
from artes.runner import _kernel_static
from artes.transport import jumps as J
from artes.transport.tables import build_tables


def _env_from_tables(t):
    g = t.grid
    nr, NT, NP = g.nr, g.ntheta, g.nphi
    cd = int(t.cell_depth)
    k3 = np.asarray(t.opacity, np.float64).reshape(nr, NT, NP)
    dk = k3 - k3[:, :1, :1]
    env = J.JumpEnv()
    env.nr, env.NT, env.NP = nr, NT, NP
    env.a2, env.b2, env.c2 = g.ob_ax ** 2, g.ob_by ** 2, g.ob_cz ** 2
    env.pos_eps = g.pos_eps
    env.rf = [float(g.rfront[i]) for i in range(nr + 1)]
    env.rf_floor = float(g.rfront[cd])
    env.kbar = [float(k3[m, 0, 0]) for m in range(nr)]
    env.tcos = [float(g.theta_cos[i]) for i in range(NT + 1)]
    plane = np.asarray(g.thetaplane_cone)
    above = np.asarray(g.theta_above)
    env.theta_faces = [(float(g.theta_tan[i]) ** 2, bool(plane[i]),
                        bool(above[i])) for i in range(1, NT)]
    env.phi_trig = [(float(g.phi_sin[p]), float(g.phi_cos[p]))
                    for p in range(NP)]
    env.jfaces = tuple(range(1, nr))
    dr = {j: jnp.asarray((dk[j] - dk[j - 1]).reshape(-1))
          for j in range(1, nr)}
    dtt = {tt: jnp.asarray((dk[:, tt, :] - dk[:, tt - 1, :]).reshape(-1))
           for tt in range(1, NT)}
    dpp = {p: jnp.asarray((dk[:, :, p] - dk[:, :, (p - 1) % NP]).reshape(-1))
           for p in range(NP)}
    dk0 = jnp.asarray(dk.reshape(-1))
    rf2 = jnp.asarray([env.rf[j] ** 2 for j in range(1, nr)])
    env.dr = lambda j, a: dr[j][a]
    env.dtt = lambda tt, idx: dtt[tt][idx]
    env.dpp = lambda p, idx: dpp[p][idx]
    env.dk0 = lambda idx: dk0[idx]
    env.locate_m = lambda r2: (jnp.searchsorted(
        rf2, r2, side="right").astype(jnp.int32), None)
    return env, k3, cd


def _brute(env, k3, cd, p0, d, ns=60000):
    """Dense midpoint integral of k along the ray (transformed coords)."""
    nr, NT, NP = env.nr, env.NT, env.NP
    rfn = np.asarray(env.rf)
    tcos = np.asarray(env.tcos)
    S = np.diag([env.a2 ** 0.5, env.b2 ** 0.5, env.c2 ** 0.5])
    P0 = S @ p0
    D = S @ d
    A = D @ D
    B = P0 @ D
    s_exit = (-B + np.sqrt(B * B - A * (P0 @ P0 - rfn[nr] ** 2))) / A
    disc_f = B * B - A * (P0 @ P0 - rfn[cd] ** 2)
    surf = False
    if disc_f > 0:
        lo = (-B - np.sqrt(disc_f)) / A
        if lo > 1e-12:
            s_exit, surf = lo, True
    phifront = None
    if NP > 1:
        sins = np.asarray([s for s, c in env.phi_trig])
        coss = np.asarray([c for s, c in env.phi_trig])
        phifront = np.arctan2(sins, coss) % (2.0 * np.pi)
    ss = (np.arange(ns) + 0.5) * (s_exit / ns)
    pts = P0[None, :] + ss[:, None] * D[None, :]
    r = np.linalg.norm(pts, axis=1)
    cr = np.clip(np.searchsorted(rfn[1:-1], r, side="right"), 0, nr - 1)
    ct = np.sum(pts[:, 2:3] / np.maximum(r[:, None], 1e-30)
                < tcos[None, 1:NT], axis=1) if NT > 1 else np.zeros(ns, int)
    if NP > 1:
        phi = np.arctan2(pts[:, 1], pts[:, 0]) % (2.0 * np.pi)
        cp = np.clip(np.searchsorted(phifront[1:], phi, side="right"),
                     0, NP - 1)
    else:
        cp = np.zeros(ns, int)
    tau = k3[cr, ct, cp].sum() * (s_exit / ns)
    return tau, surf


@pytest.mark.parametrize("oblateness", [0.0, 0.15])
def test_jump_walk_matches_brute_force(oblateness):
    th = tuple(np.linspace(0.0, 180.0, 5))
    ph = tuple(np.linspace(0.0, 360.0, 5)[:-1])
    atm = presets.patchy_3d(tau_clear=0.5, tau_cloud=4.0, nr=6,
                            theta_deg=th, phi_deg=ph)
    prof = np.exp(np.linspace(1.0, -1.0, 6))[:, None, None, None]
    atm.k_sca = atm.k_sca * prof
    atm.k_abs = atm.k_abs * prof
    atm.refresh_derived()
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    cfg.oblateness = oblateness
    det = detector_setup(cfg, float(atm.rfront[-1]))
    prep = build_tables(atm, cfg, det, 0, dtype=jnp.float64)
    env, k3, cd = _env_from_tables(prep.tables)

    rfn = np.asarray(env.rf)
    tcos = np.asarray(env.tcos)
    rng = np.random.default_rng(7)
    worst = 0.0
    for _ in range(15):
        r = rfn[cd] + (rfn[-1] - rfn[cd]) * rng.uniform(0.02, 0.98)
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        # start point in TRANSFORMED coords at radius r, map back
        Sinv = np.diag([1.0 / env.a2 ** 0.5, 1.0 / env.b2 ** 0.5,
                        1.0 / env.c2 ** 0.5])
        p0 = Sinv @ (r * u)
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        # locate the starting cell in transformed coords
        cr0 = int(np.clip(np.searchsorted(rfn[1:-1], r, side="right"),
                          0, env.nr - 1))
        X = r * u
        ct0 = int(np.sum(X[2] / r < tcos[1:env.NT])) if env.NT > 1 else 0
        if env.NP > 1:
            sins = np.asarray([s for s, c in env.phi_trig])
            coss = np.asarray([c for s, c in env.phi_trig])
            pf = np.arctan2(sins, coss) % (2.0 * np.pi)
            phi0 = np.arctan2(X[1], X[0]) % (2.0 * np.pi)
            cp0 = int(np.clip(np.searchsorted(pf[1:], phi0, side="right"),
                              0, env.NP - 1))
        else:
            cp0 = 0
        out = J.tau_walk_jumps(
            env,
            *[jnp.asarray(np.full(1, v)) for v in p0],
            *[jnp.asarray(np.full(1, v)) for v in d],
            jnp.asarray([cr0], jnp.int32), jnp.asarray([ct0], jnp.int32),
            jnp.asarray([cp0], jnp.int32))
        tj = float(out["tau"][0])
        sj = bool(out["surface"][0])
        tb, sb = _brute(env, k3, cd, p0, d)
        assert sj == sb
        worst = max(worst, abs(tj - tb) / max(tb, 1e-12))
    # reference discretization error ~ k_max * s / ns ~ 1e-4; the walk is
    # exact, so the diff is bounded by the brute-force step
    assert worst < 2.0e-3, worst
