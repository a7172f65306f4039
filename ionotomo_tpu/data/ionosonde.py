"""Ionosonde / density-probe observations: point n_e constraints.

Context. The reference treats the vertical profile as a fixed input (its
``a_priori_model`` takes Chapman parameters as constants; SURVEY.md §2
"A-priori ionosphere model") and its real-data layer ingests only dTEC.
The measured limits of that data mix (DESIGN.md §8): dTEC is
exactly blind to the horizontally-uniform profile, VTEC anchors pin the
column *integral* but not its altitude shape, and multi-elevation slant
anchors make the Chapman parameters identifiable only to ~5 km (single
layer) / ~25 km (multi-layer with a free voxel field — the field absorbs
part of the height shift). The instrument that measures the profile
*directly* is the ionosonde: a swept-frequency HF sounder whose echo
delays give the bottomside n_e(h) up to each layer peak (reflection at
plasma frequency f_p = 8.98·√n_e; the topside above the F2 peak reflects
nothing and is invisible — the classic bottomside limitation).

This module represents such data as **point log-density observations**
("probes"). Because the engine's unknown IS the log-density field m with
n_e = K_NE·e^m, a log-density observation is exactly *linear* in the
model: H m = tricubic interpolation at the probe points
(``forward.tec.log_ne_at``); log-space noise ≈ relative density error,
matching how ionogram inversions are actually quoted. Probe rows
therefore join the MAP / parametric-profile solves with the solver's own
machinery (``solvers.map_gauss_newton(..., probes=...)``,
``profile.map_gauss_newton_profile(..., probes=...)``) or are
sequentially assimilated into the prior mean
(``anchors.assimilate_probes``) exactly like VTEC anchors.

This is an additional-capability module (the reference has no profile-
observation channel); it exists because rounds 2–3 *measured* that no
TEC-derived data can fully constrain the profile shape.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..core.grids import Grid3D

# Sounder visibility floor: a ~1 MHz minimum sounding frequency reflects
# where f_p = 1 MHz → n_e = (1e6 / 8.98)² ≈ 1.24e10 m^-3; densities below
# are invisible to any ionosonde, so synthetic bottomside sampling starts
# there.
MIN_SOUNDER_NE = (1.0e6 / constants.PLASMA_COEF) ** 2


class NeProbes(NamedTuple):
    """Point density constraints: ``values[p] ≈ m(points[p])`` — log
    density in the model's own units log(n_e/K_NE) — weighted by the
    log-space ``noise_std`` (scalar or (P,); ≈ relative n_e error)."""

    points: jax.Array      # (P, 3) ENU km
    values: jax.Array      # (P,)
    noise_std: jax.Array   # scalar or (P,)


def _check_in_grid(grid: Grid3D, pts: np.ndarray, what: str):
    origin = np.asarray(jax.device_get(grid.origin), np.float64)
    span = np.asarray(jax.device_get(grid.spacing), np.float64) * (
        np.asarray(grid.shape) - 1)
    bad = np.zeros(pts.shape[0], bool)
    for a in range(3):
        bad |= (pts[:, a] < origin[a]) | (pts[:, a] > origin[a] + span[a])
    if bad.any():
        lo, hi = origin, origin + span
        raise ValueError(
            f"{int(bad.sum())} {what} point(s) fall outside the grid "
            f"x∈[{lo[0]:.0f},{hi[0]:.0f}], y∈[{lo[1]:.0f},{hi[1]:.0f}], "
            f"z∈[{lo[2]:.0f},{hi[2]:.0f}] km — out-of-grid probes would "
            "be edge-clamped by the tricubic interpolant and bias the "
            "solve; drop them or enlarge the grid")


def probes_from_arrays(grid: Grid3D, points_enu, ne_m3, noise_frac
                       ) -> NeProbes:
    """Build probes from physical arrays: ``points_enu`` (P,3) ENU km,
    ``ne_m3`` (P,) electron densities [m^-3], ``noise_frac`` relative
    density error (scalar or (P,)). Validates positivity and grid
    containment (edge-clamped out-of-grid probes would silently bias
    every solve, same contract as ``anchors.anchors_from_npz``)."""
    pts = np.atleast_2d(np.asarray(points_enu, np.float64))
    ne = np.asarray(ne_m3, np.float64).ravel()
    if pts.shape != (ne.shape[0], 3):
        raise ValueError(f"points_enu {pts.shape} vs ne_m3 {ne.shape}: "
                         "need (P,3) points and (P,) densities")
    if not np.all(ne > 0):
        raise ValueError("ionosonde densities must be positive "
                         f"(min given: {ne.min():.3g} m^-3)")
    _check_in_grid(grid, pts, "ionosonde probe")
    noise = np.asarray(noise_frac, np.float64)
    if np.any(noise <= 0):
        raise ValueError("noise_frac must be positive")
    return NeProbes(points=jnp.asarray(pts, jnp.float32),
                    values=jnp.asarray(np.log(ne / constants.K_NE),
                                       jnp.float32),
                    noise_std=jnp.asarray(noise, jnp.float32))


def probes_from_npz(grid: Grid3D, path) -> NeProbes:
    """Load the CLI npz format: ``points_enu`` (P,3) ENU km, ``ne_m3``
    (P,) [m^-3], ``noise_frac`` scalar (or (P,)) relative density error
    — shared by ``invert --ionosonde``."""
    with np.load(path) as z:
        return probes_from_arrays(grid, z["points_enu"], z["ne_m3"],
                                  z["noise_frac"])


def probes_to_npz(path, probes: NeProbes):
    """Write probes back to the CLI npz format (synthetic-study /
    round-trip helper)."""
    np.savez(path,
             points_enu=np.asarray(jax.device_get(probes.points),
                                   np.float64),
             ne_m3=constants.K_NE * np.exp(np.asarray(
                 jax.device_get(probes.values), np.float64)),
             noise_frac=np.asarray(jax.device_get(probes.noise_std),
                                   np.float64))


def bottomside_probes(field_m, grid: Grid3D, stations_xy,
                      n_per_station: int = 10, noise_log: float = 0.05,
                      seed: int = 0, min_ne: float = MIN_SOUNDER_NE
                      ) -> NeProbes:
    """Simulate ionosonde soundings from a (truth) field: for each station
    at ENU ``stations_xy`` (S,2) km, sample ``n_per_station`` bottomside
    points — altitudes from where the column density first exceeds
    ``min_ne`` (the sounder's reflection floor) up to the column's density
    peak, the physically visible range — and observe the truth's log
    density there with ``noise_log`` log-space (≈ relative) noise.
    Bench/test helper; real data enters through ``probes_from_arrays``.
    """
    from ..forward.tec import log_ne_at

    xy = np.atleast_2d(np.asarray(stations_xy, np.float64))
    origin = np.asarray(jax.device_get(grid.origin), np.float64)
    sp = np.asarray(jax.device_get(grid.spacing), np.float64)
    nz = grid.shape[2]
    # fine column scan (4× grid resolution) to locate floor and peak
    z_fine = origin[2] + sp[2] * (nz - 1) * np.linspace(0.0, 1.0, 4 * nz)
    cols = np.concatenate(
        [np.broadcast_to(xy[:, None, :], (xy.shape[0], z_fine.size, 2)),
         np.broadcast_to(z_fine[None, :, None],
                         (xy.shape[0], z_fine.size, 1))], axis=-1)
    m_cols = np.asarray(jax.device_get(
        log_ne_at(field_m, grid, jnp.asarray(cols, jnp.float32))),
        np.float64)
    m_floor = np.log(min_ne / constants.K_NE)
    pts = []
    for s in range(xy.shape[0]):
        # a field holding -inf (or NaN through interpolation of one)
        # would poison np.argmax, which returns the first NaN index;
        # treat any non-finite column value as "no density"
        col = np.where(np.isfinite(m_cols[s]), m_cols[s], -np.inf)
        i_pk = int(np.argmax(col))
        vis = np.flatnonzero(col[: i_pk + 1] >= m_floor)
        if vis.size == 0:
            raise ValueError(
                f"station {s}: no bottomside density above the sounder "
                f"floor {min_ne:.2g} m^-3 — the field is empty at this "
                "column")
        # n_per_station altitudes evenly spanning [first visible, peak]
        z_lo, z_hi = z_fine[vis[0]], z_fine[i_pk]
        zs = np.linspace(z_lo, z_hi, n_per_station)
        pts.append(np.stack([np.full_like(zs, xy[s, 0]),
                             np.full_like(zs, xy[s, 1]), zs], axis=-1))
    pts = np.concatenate(pts, axis=0)
    points = jnp.asarray(pts, jnp.float32)
    truth = log_ne_at(field_m, grid, points)
    noise = noise_log * jax.random.normal(jax.random.key(seed),
                                          truth.shape)
    return NeProbes(points=points, values=truth + noise,
                    noise_std=jnp.float32(noise_log))
