"""Host-side per-wavelength table preparation for the transport kernel.

This is the counterpart of ``grid_initialize`` mode 2 (ARTES.f90:2325-2505):
the photon floor ``cell_depth`` (tau > 30 for stellar, tau_abs > 5 for thermal
sources), thermal cell luminosities L = 4 pi V kappa_abs B_lambda with
emission weights and the cumulative emissivity CDF, plus flattening of the
cell tables into the layouts the kernel gathers from. All lengths are scaled
by the outer radius so the kernel runs in unit-sphere coordinates.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from artes.constants import PI, planck_lambda
from artes.transport import sampling as S
from artes.transport.geometry import make_grid_geometry
from artes.transport.kernel import TransportTables


def compute_cell_depth(atm, wl_index: int, photon_source: int, ring: bool = False) -> int:
    """Radial photon floor (ARTES.f90:2329-2393).

    Stellar: deepest radial index where every (theta,phi) column reaches
    total tau > 30 scanning from the top; thermal: absorption tau > 5.
    Returns the *minimum* depth over columns.
    """
    if photon_source == 1:
        k = atm.k_ext[:, :, :, wl_index]
        limit = 30.0
        grid_out = 0
    else:
        k = atm.k_abs[:, :, :, wl_index]
        limit = 5.0
        grid_out = 2 if ring else 0
    nr = atm.nr
    dr = np.diff(atm.rfront)
    cell_max = nr
    for j in range(atm.ntheta):
        for p in range(atm.nphi):
            tau = 0.0
            depth = nr - 1
            for i in range(grid_out, nr):
                idx = nr - i - 1
                tau += k[idx, j, p] * dr[idx]
                depth = idx
                if tau > limit:
                    break
            cell_max = min(cell_max, depth)
    return int(cell_max)


def thermal_emission_tables(atm, wl_index: int, cell_depth: int, thermal_weight: bool,
                            oblateness: float = 0.0):
    """Cell luminosity, emission weights and cumulative emissivity CDF
    (ARTES.f90:2395-2453). Returns (luminosity, weight, cum) flattened over
    cells in (r, theta, phi) lexicographic order; ``cum[-1]`` is the total
    weighted emissivity [W m-1]."""
    nr, nt, npp = atm.nr, atm.ntheta, atm.nphi
    wavelength = atm.wavelengths[wl_index]
    volume = atm.cell_volume(1.0 / (1.0 - oblateness), 1.0 / (1.0 - oblateness), 1.0)
    k_abs = atm.k_abs[:, :, :, wl_index]
    temp = atm.temperature
    planck = np.where(temp > 0.0, planck_lambda(np.maximum(temp, 1.0), wavelength), 0.0)
    emitting = (temp > 0.0) & (k_abs > 0.0)
    emitting[:cell_depth] = False
    lum = np.where(emitting, 4.0 * PI * volume * k_abs * planck, 0.0)  # [W m-1]
    weight_norm = float((volume * k_abs * planck * ((temp > 0.0) &
                         (np.arange(nr)[:, None, None] >= cell_depth))).sum())
    if thermal_weight:
        with np.errstate(divide="ignore", invalid="ignore"):
            weight = np.where(emitting,
                              weight_norm / np.maximum(volume * k_abs * planck, 1e-300), 1.0)
    else:
        weight = np.ones_like(lum)
    contrib = np.where(emitting, lum * weight, 0.0).reshape(-1)
    cum = np.cumsum(contrib)
    return lum, weight.reshape(-1), cum


@dataclasses.dataclass
class PreparedWavelength:
    """Everything the runner needs for one wavelength."""

    tables: TransportTables
    r_scale: float
    cell_depth: int
    emissivity_total: float   # [W m-1] (0 for stellar runs)
    cell_luminosity: np.ndarray | None


def build_tables(atm, cfg, det, wl_index: int, dtype=jnp.float64) -> PreparedWavelength:
    """Assemble device tables for wavelength ``wl_index``.

    ``cfg`` is an :class:`~artes.config.ArtesConfig`; ``det`` a
    :class:`~artes.config.DetectorSetup`.
    """
    source = 1 if cfg.photon_source == "star" else 2
    grid, r_scale = make_grid_geometry(atm, cfg.oblateness, dtype=dtype)
    cell_depth = compute_cell_depth(atm, wl_index, source, cfg.ring)

    ncell = atm.nr * atm.ntheta * atm.nphi
    k_ext = atm.k_ext[:, :, :, wl_index].reshape(-1) * r_scale  # per scaled length
    albedo = atm.albedo[:, :, :, wl_index].reshape(-1)
    scatter = np.ascontiguousarray(atm.scatter[:, :, :, wl_index])  # (nr,nt,np,180,16)
    scatter_rows = scatter.reshape(ncell * 180, 16)
    alpha_prefix = S.build_alpha_prefix(scatter.reshape(ncell, 180, 16))
    p_int = atm.p_int[:, :, :, wl_index].reshape(ncell, 4)

    lum = None
    emis_total = 0.0
    if source == 2:
        lum, weight, cum = thermal_emission_tables(
            atm, wl_index, cell_depth, cfg.thermal_weight, cfg.oblateness)
        emis_total = float(cum[-1])
    else:
        weight = np.ones(ncell)
        cum = np.zeros(ncell)

    st, ct = np.sin(det.det_theta), np.cos(det.det_theta)
    sp, cp = np.sin(det.det_phi), np.cos(det.det_phi)

    # host-side (numpy) tables, uploaded once per kernel dispatch. Matches
    # the executed dtype: with x64 off, jnp used to silently degrade f64
    # tables to f32 at creation.
    npdtype = (np.float64
               if (dtype == jnp.float64
                   and jnp.asarray(0.0, jnp.float64).dtype == jnp.float64)
               else np.float32)
    tables = TransportTables(
        grid=grid,
        opacity=np.asarray(k_ext, npdtype),
        albedo=np.asarray(albedo, npdtype),
        scatter_rows=np.asarray(scatter_rows, npdtype),
        alpha_prefix=np.asarray(alpha_prefix, npdtype),
        p_int=np.asarray(p_int, npdtype),
        cell_depth=np.asarray(cell_depth, np.int32),
        emis_cum=np.asarray(cum, npdtype),
        cell_weight=np.asarray(weight, npdtype),
        det_dir=np.asarray(det.direction, npdtype),
        det_trig=np.asarray([st, ct, sp, cp], npdtype),
        x_max=np.asarray(det.x_max / r_scale, npdtype),
        y_max=np.asarray(det.y_max / r_scale, npdtype),
        surface_albedo=np.asarray(cfg.surface_albedo, npdtype),
        fstop=np.asarray(cfg.fstop, npdtype),
        photon_minimum=np.asarray(cfg.photon_minimum, npdtype),
        photon_bias=np.asarray(cfg.photon_bias, npdtype),
        star_theta=np.asarray(cfg.theta_star, npdtype),
        star_phi=np.asarray(cfg.phi_star, npdtype),
    )
    return PreparedWavelength(tables=tables, r_scale=r_scale, cell_depth=cell_depth,
                              emissivity_total=emis_total, cell_luminosity=lum)
