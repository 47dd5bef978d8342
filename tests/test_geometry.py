"""Geometry kernel tests: batched cell_face vs brute-force checks.

Strategy from SURVEY.md section 4: verify face distances against independent
predicates (membership of the advanced point, analytic chord lengths) rather
than porting the reference's control flow.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from artes.transport import geometry as G


class FakeAtm:
    def __init__(self, rfront, theta_deg, phi_deg):
        self.rfront = np.asarray(rfront, dtype=float)
        th = np.asarray(theta_deg, dtype=float)
        self.thetafront = th * np.pi / 180.0
        self.thetaplane = np.where(np.abs(th - 90.0) < 1e-6, 2, 1)
        self.phifront = np.asarray(phi_deg, dtype=float) * np.pi / 180.0
        self.theta_cos = np.cos(self.thetafront)
        self.theta_tan = np.tan(self.thetafront)
        self.phi_sin = np.sin(self.phifront)
        self.phi_cos = np.cos(self.phifront)
        self.nr = len(self.rfront) - 1
        self.ntheta = len(self.thetafront) - 1
        self.nphi = len(self.phifront)


def locate(atm, pos, a=1.0):
    """Host-side cell location in scaled coords (independent of the kernel)."""
    x, y, z = pos[..., 0] * a, pos[..., 1] * a, pos[..., 2]
    r = np.sqrt(x * x + y * y + z * z)
    theta = np.arccos(np.clip(z / r, -1, 1))
    phi = np.arctan2(y, x) % (2 * np.pi)
    rf = atm.rfront / atm.rfront[-1]
    ir = np.searchsorted(rf, r) - 1
    it = np.searchsorted(atm.thetafront, theta) - 1
    if atm.nphi > 1:
        ip = np.searchsorted(atm.phifront, phi) - 1
        ip = np.clip(ip, 0, atm.nphi - 1)
    else:
        ip = np.zeros_like(ir)
    return np.stack([ir, it, ip], axis=-1)


def sample_interior(atm, n, rng, a=1.0):
    """Random points uniformly inside the grid shell, in scaled coords."""
    rf = atm.rfront / atm.rfront[-1]
    r = rng.uniform(rf[0] * 1.001, 0.999, n)
    ct = rng.uniform(-0.999, 0.999, n)
    st = np.sqrt(1 - ct * ct)
    ph = rng.uniform(0, 2 * np.pi, n)
    pos = np.stack([r * st * np.cos(ph) / a, r * st * np.sin(ph) / a, r * ct], axis=-1)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return pos, d


GRIDS = [
    FakeAtm([7.0e7, 7.01e7, 7.02e7], [0, 180], []),
    FakeAtm([7.0e7, 7.05e7, 7.1e7, 7.2e7], [0, 60, 90, 120, 180], [0, 90, 180, 270]),
    FakeAtm([7.0e7, 7.1e7], [0, 45, 135, 180], [0, 120, 240]),
]


@pytest.mark.parametrize("atm_idx", range(len(GRIDS)))
def test_cell_face_advances_to_neighbor(atm_idx):
    atm = GRIDS[atm_idx]
    grid, _ = G.make_grid_geometry(atm)
    rng = np.random.default_rng(42 + atm_idx)
    n = 400
    pos, dirn = sample_interior(atm, n, rng)
    cell = locate(atm, pos)
    # keep points that are safely inside their cell
    ok = (cell[:, 0] >= 0) & (cell[:, 0] < atm.nr)
    pos, dirn, cell = pos[ok], dirn[ok], cell[ok]

    out = G.cell_face(
        grid, jnp.asarray(pos), jnp.asarray(dirn),
        jnp.asarray(cell, jnp.int32),
        jnp.zeros((len(pos), 2), jnp.int32),
        cell_depth=0,
    )
    d = np.asarray(out["distance"])
    err = np.asarray(out["error"])
    cell_out = np.asarray(out["cell_out"])
    exit_ = np.asarray(out["grid_exit"])
    assert not err.any(), f"{err.sum()} traversal errors"
    assert (d > 0).all()

    delta = 1e-9
    before = locate(atm, pos + (d - delta)[:, None] * dirn)
    after = locate(atm, pos + (d + delta)[:, None] * dirn)
    # just before the face: still in the original cell
    frac_before = (before == cell).all(axis=1).mean()
    assert frac_before > 0.97, f"only {frac_before:.3f} still in cell before face"
    # just after the face: in the reported neighbour (or out of the grid)
    inside = ~exit_ & (after[:, 0] >= 0) & (after[:, 0] < atm.nr)
    frac_after = (after[inside] == cell_out[inside]).all(axis=1).mean()
    assert frac_after > 0.97, f"only {frac_after:.3f} in predicted neighbour"
    # grid exit flagged exactly when the outer face is crossed
    r_after = np.linalg.norm(pos + (d + delta)[:, None] * dirn, axis=-1)
    np.testing.assert_array_equal(exit_, np.asarray(cell_out[:, 0] == atm.nr))
    assert (r_after[exit_] > 0.999).all()


def test_full_march_chord_length():
    """March a pencil of rays through a spherically-symmetric grid: the total
    path length must equal the analytic chord 2*sqrt(R^2-b^2)."""
    atm = GRIDS[1]
    grid, _ = G.make_grid_geometry(atm)
    rng = np.random.default_rng(7)
    n = 128
    rf = atm.rfront / atm.rfront[-1]
    shell = 1.0 - rf[0]
    b = rng.uniform(rf[0] + 0.05 * shell, 1.0 - 0.02 * shell, n)  # misses inner sphere
    phi = rng.uniform(0, 2 * np.pi, n)
    # start on outer sphere travelling -x
    y = b * np.cos(phi)
    z = b * np.sin(phi)
    x = np.sqrt(1.0 - b * b)
    pos = np.stack([x, y, z], axis=-1) * (1 - 1e-12)
    dirn = np.tile(np.array([-1.0, 0.0, 0.0]), (n, 1))
    cell = locate(atm, pos * (1 - 1e-9))
    cell[:, 0] = atm.nr - 1
    face = np.tile(np.array([1, atm.nr], np.int32), (n, 1))

    total = np.zeros(n)
    active = np.ones(n, bool)
    pos_j = jnp.asarray(pos)
    cell_j = jnp.asarray(cell, jnp.int32)
    face_j = jnp.asarray(face, jnp.int32)
    for _ in range(64):
        out = G.cell_face(grid, pos_j, jnp.asarray(dirn), cell_j, face_j, cell_depth=0)
        d = np.asarray(out["distance"])
        err = np.asarray(out["error"])
        assert not (err & active).any()
        total += np.where(active, d, 0.0)
        pos_j = pos_j + jnp.asarray(d[:, None] * np.asarray(dirn)) * active[:, None]
        cell_j = out["cell_out"]
        face_j = out["next_face"]
        active &= ~np.asarray(out["grid_exit"])
        if not active.any():
            break
    assert not active.any(), f"{active.sum()} rays never exited"
    # rays with b > inner radius pass through; those hitting the inner sphere
    # would stop there, but we chose b above it
    chord = 2.0 * np.sqrt(1.0 - b * b)
    np.testing.assert_allclose(total, chord, rtol=1e-8)


def test_inner_sphere_blocks_ray():
    """A central ray must reach the inner boundary at distance R_out - R_in."""
    atm = GRIDS[0]
    grid, _ = G.make_grid_geometry(atm)
    rf = atm.rfront / atm.rfront[-1]
    pos = jnp.asarray([[1.0 - 1e-12, 0.0, 0.0]])
    dirn = jnp.asarray([[-1.0, 0.0, 0.0]])
    cell = jnp.asarray([[atm.nr - 1, 0, 0]], jnp.int32)
    face = jnp.asarray([[1, atm.nr]], jnp.int32)
    total = 0.0
    for _ in range(atm.nr):
        out = G.cell_face(grid, pos, dirn, cell, face, cell_depth=0)
        total += float(out["distance"][0])
        pos = pos + out["distance"][:, None] * dirn
        cell, face = out["cell_out"], out["next_face"]
    # after nr steps we are at the innermost face
    assert total == pytest.approx(1.0 - rf[0], rel=1e-9)
    assert int(face[0, 1]) == 0


def test_equatorial_plane_crossing():
    """thetaplane==2: the theta=90 face is the z=0 plane."""
    atm = GRIDS[1]  # has a 90-degree face (index 2)
    grid, _ = G.make_grid_geometry(atm)
    # photon just above the plane moving straight down
    r_mid = 0.5 * (atm.rfront[0] + atm.rfront[1]) / atm.rfront[-1]
    z0 = 1e-4
    x0 = np.sqrt(r_mid**2 - z0**2)
    pos = jnp.asarray([[x0, 0.0, z0]])
    dirn = jnp.asarray([[0.0, 0.0, -1.0]])
    cell = jnp.asarray([[0, 1, 0]], jnp.int32)  # theta cell 1 = (60, 90)
    face = jnp.zeros((1, 2), jnp.int32)
    out = G.cell_face(grid, pos, dirn, cell, face, cell_depth=0)
    assert float(out["distance"][0]) == pytest.approx(z0, rel=1e-10)
    assert out["next_face"][0].tolist() == [2, 2]
    assert out["cell_out"][0].tolist() == [0, 2, 0]


def test_same_face_recrossing():
    """A photon that crossed a radial face inward but misses the inner sphere
    must re-cross the same face outward (ARTES.f90:2933-2954)."""
    atm = GRIDS[0]
    grid, _ = G.make_grid_geometry(atm)
    rf = atm.rfront / atm.rfront[-1]
    r_face = rf[1]
    b = 0.5 * (rf[0] + rf[1])  # impact parameter between inner and face
    # photon on the face, direction with impact parameter b
    pos = jnp.asarray([[np.sqrt(r_face**2 - b**2), b, 0.0]])
    dirn = jnp.asarray([[-1.0, 0.0, 0.0]])
    cell = jnp.asarray([[0, 0, 0]], jnp.int32)
    face = jnp.asarray([[1, 1]], jnp.int32)  # sitting on radial face 1
    out = G.cell_face(grid, pos, dirn, cell, face, cell_depth=0)
    # chord across the face-1 sphere
    expected = 2.0 * np.sqrt(r_face**2 - b**2)
    assert float(out["distance"][0]) == pytest.approx(expected, rel=1e-9)
    assert out["next_face"][0].tolist() == [1, 1]
    assert out["cell_out"][0].tolist() == [1, 0, 0]


def test_oblate_radial_crossing():
    """With oblateness, radial faces are ellipsoids: a polar ray crosses at
    scaled z = rfront (c=1), an equatorial ray at x = rfront/(1-obl)."""
    atm = GRIDS[0]
    obl = 0.3
    grid, _ = G.make_grid_geometry(atm, oblateness=obl)
    rf = atm.rfront / atm.rfront[-1]
    # equatorial ray from outside inward along -x: outer surface at x=1/(1-obl)
    x_out = 1.0 / (1 - obl)
    pos = jnp.asarray([[x_out * (1 - 1e-12), 0.0, 0.0]])
    dirn = jnp.asarray([[-1.0, 0.0, 0.0]])
    cell = jnp.asarray([[atm.nr - 1, 0, 0]], jnp.int32)
    face = jnp.asarray([[1, atm.nr]], jnp.int32)
    out = G.cell_face(grid, pos, dirn, cell, face, cell_depth=0)
    expected = (1.0 - rf[1]) / (1 - obl)
    assert float(out["distance"][0]) == pytest.approx(expected, rel=1e-9)


def test_phi_wraparound_march():
    """A ray circling in the equatorial plane must wrap phi cells 2->0."""
    atm = FakeAtm([1.0e7, 7.5e7], [0, 180], [0, 120, 240])
    grid, _ = G.make_grid_geometry(atm)
    r = 0.5
    # position in phi cell 2 (330 deg), direction tangential (increasing phi);
    # with this thick shell the phi=0 face comes before the outer sphere
    ang = np.deg2rad(330.0)
    pos = jnp.asarray([[r * np.cos(ang), r * np.sin(ang), 0.0]])
    dirn = jnp.asarray([[-np.sin(ang), np.cos(ang), 0.0]])
    cell = jnp.asarray([[0, 0, 2]], jnp.int32)
    face = jnp.zeros((1, 2), jnp.int32)
    out = G.cell_face(grid, pos, dirn, cell, face, cell_depth=0)
    assert not bool(out["error"][0])
    nf = out["next_face"][0].tolist()
    co = out["cell_out"][0].tolist()
    # crossing the phi=0 face outward into cell 0 (or the outer radial face,
    # depending on r) — for r=0.97 the phi face comes first
    assert nf == [3, 0]
    assert co == [0, 0, 0]


def test_locate_cell_matches_host():
    atm = GRIDS[1]
    grid, _ = G.make_grid_geometry(atm)
    rng = np.random.default_rng(3)
    pos, _ = sample_interior(atm, 256, rng)
    host = locate(atm, pos)
    dev = np.asarray(G.locate_cell(grid, jnp.asarray(pos), jnp.asarray(host[:, 0], jnp.int32)))
    np.testing.assert_array_equal(dev[:, 1], host[:, 1])
    np.testing.assert_array_equal(dev[:, 2], host[:, 2])


@pytest.mark.parametrize("ob", [0.1, 0.3])
def test_oblate_cell_face_vs_brute_force(ob):
    """f64 cross-check of the oblate traversal (VERDICT r1 item 2): the
    distance reported by cell_face must equal the first membership change
    along the ray found by dense scan + bisection with an independent
    host-side cell locator (oblate scalings ARTES.f90:2838-2840, 2891-2907).
    """
    atm = GRIDS[1]
    a = 1.0 - ob
    grid, _ = G.make_grid_geometry(atm, oblateness=ob)
    rng = np.random.default_rng(11)
    pos, dirn = sample_interior(atm, 300, rng, a=a)
    cell = locate(atm, pos, a=a)
    ok = (cell[:, 0] >= 0) & (cell[:, 0] < atm.nr)
    pos, dirn, cell = pos[ok], dirn[ok], cell[ok]

    out = G.cell_face(
        grid, jnp.asarray(pos), jnp.asarray(dirn),
        jnp.asarray(cell, jnp.int32),
        jnp.zeros((len(pos), 2), jnp.int32), cell_depth=0,
    )
    d = np.asarray(out["distance"])
    assert not np.asarray(out["error"]).any()
    assert (d > 0).all()

    checked = 0
    for i in range(min(64, len(pos))):
        # dense scan for the first membership change
        ts = np.linspace(1e-10, 1.5 * d[i], 30001)
        cells = locate(atm, pos[i][None] + ts[:, None] * dirn[i][None], a=a)
        changed = (cells != cell[i]).any(axis=1)
        if not changed.any():
            continue
        k = int(np.argmax(changed))
        lo, hi = ts[max(k - 1, 0)], ts[k]
        for _ in range(60):  # bisection refine
            mid = 0.5 * (lo + hi)
            if (locate(atm, pos[i][None] + mid * dirn[i][None], a=a)
                    != cell[i]).any():
                hi = mid
            else:
                lo = mid
        assert abs(hi - d[i]) < 1e-8 * max(d[i], 1e-3), \
            f"ray {i}: brute {hi} vs cell_face {d[i]}"
        checked += 1
    assert checked > 40
