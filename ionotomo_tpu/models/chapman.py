"""Chapman-layer a-priori electron density model (device-side, jnp).

Numerical contract (SURVEY.md §8): ``n_e(h) = N_peak * exp(0.5 * (1 - z -
exp(-z)))`` with ``z = (h - h_peak)/H``; optional solar-zenith (day/night)
modulation. This is the reference's ``a_priori_model`` /
``create_initial_model`` capability (SURVEY.md §2 "A-priori ionosphere
model") rebuilt as pure functions over Grid3D fields.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..core.grids import Grid3D


def chapman_ne(h_km, n_peak=1.0e12, h_peak_km=350.0, scale_km=80.0):
    """Chapman profile n_e(h) in m^-3. h_km may be any jnp array shape."""
    z = (h_km - h_peak_km) / scale_km
    return n_peak * jnp.exp(0.5 * (1.0 - z - jnp.exp(-z)))


def altitude_field(grid: Grid3D, earth_radius_km=None, site_height_km=0.0):
    """True altitude above the Earth's surface for every voxel of an ENU grid.

    The ENU tangent plane falls away from the curved Earth: a voxel at
    horizontal offset r and plane-height z sits at altitude
    ``h = sqrt(r² + (R + h0 + z)²) − R`` (R = osculating-sphere radius,
    h0 = site altitude) — +12.5 km at r = 400 km, +25 km at 565 km. The
    reference computes heights through astropy's exact ITRS chain
    (SURVEY.md §2 "A-priori ionosphere model"); this is the device-side
    equivalent, exact on the osculating sphere (pass
    ``frames.gaussian_earth_radius(lat)`` for ≲0.1 km agreement with the
    WGS84 ellipsoid out to ~500 km).

    Returns an (nx, ny, nz) jnp array of altitudes [km].
    """
    from .. import constants as _c
    r_earth = _c.EARTH_RADIUS_KM if earth_radius_km is None else earth_radius_km
    x = grid.origin[0] + grid.spacing[0] * jnp.arange(grid.shape[0])
    y = grid.origin[1] + grid.spacing[1] * jnp.arange(grid.shape[1])
    z = grid.origin[2] + grid.spacing[2] * jnp.arange(grid.shape[2])
    r2 = (x[:, None, None] ** 2 + y[None, :, None] ** 2)
    zc = r_earth + site_height_km + z[None, None, :]
    return jnp.sqrt(r2 + zc * zc) - r_earth


def terminator_cos_chi(grid: Grid3D, enu_frame, mjd):
    """Per-column solar-zenith cosine map, (nx, ny, 1) f32 — the
    horizontally varying day/night driver for wide grids, ready to pass
    as ``cos_chi`` to the field builders. Host-side helper shared by the
    pipeline's curved-Earth prior and the synthetic-world generator
    (geometry.frames.solar_cos_zenith_field does the geometry)."""
    from ..geometry import frames
    ax = np.asarray(grid.axes()[0], np.float64)
    ay = np.asarray(grid.axes()[1], np.float64)
    cc = frames.solar_cos_zenith_field(mjd, enu_frame,
                                       ax[:, None], ay[None, :])
    return jnp.asarray(cc[..., None], jnp.float32)


def solar_zenith_factor(cos_chi, floor=0.05):
    """Day/night modulation: sqrt(max(cos χ, floor)) Chapman scaling."""
    return jnp.sqrt(jnp.maximum(cos_chi, floor))


def chapman_field(grid: Grid3D, n_peak=1.0e12, h_peak_km=350.0,
                  scale_km=80.0, cos_chi=None, curved=False,
                  earth_radius_km=None):
    """Sample the Chapman profile onto a Grid3D (z axis = plane height, km).

    Returns n_e in m^-3 with shape ``grid.shape``. ``cos_chi`` (scalar or
    per-voxel) applies the solar-zenith factor to N_peak. With
    ``curved=True`` the profile is evaluated at each voxel's true altitude
    above the curved Earth (``altitude_field``) instead of its ENU plane
    height — the reference's astropy-exact behaviour; flat (default) and
    curved differ by up to 25 km of altitude at the corners of a ±400 km
    grid.
    """
    if curved:
        h = altitude_field(grid, earth_radius_km)
        field = chapman_ne(h, n_peak, h_peak_km, scale_km)
    else:
        z_axis = grid.origin[2] + grid.spacing[2] * jnp.arange(grid.shape[2])
        prof = chapman_ne(z_axis, n_peak, h_peak_km, scale_km)  # (nz,)
        field = jnp.broadcast_to(prof[None, None, :], grid.shape)
    if cos_chi is not None:
        field = field * solar_zenith_factor(cos_chi)
    return field


#: Canonical daytime mid-latitude layer stack: (name, N_peak m^-3,
#: h_peak km, scale height km, solar_sensitivity). ``solar_sensitivity``
#: scales how strongly the layer follows the solar-zenith factor (the E
#: and F1 layers are photochemically controlled and track the sun; the
#: F2 layer is transport-dominated and only partially fades at night).
DEFAULT_LAYERS = (
    ("E",  1.2e11, 110.0, 10.0, 1.0),
    ("F1", 2.5e11, 180.0, 40.0, 1.0),
    ("F2", 1.0e12, 350.0, 80.0, 0.5),
)


def multi_chapman_ne(h_km, layers=DEFAULT_LAYERS, cos_chi=None,
                     plasmasphere_n0=0.0, plasmasphere_scale_km=1200.0):
    """Multi-layer ionosphere profile: sum of Chapman layers (E/F1/F2 by
    default) plus an optional exponential plasmasphere tail above the F2
    peak — the realistic composite the reference's ``a_priori_model``
    family represents (single Chapman is the ``chapman_ne`` special case).

    ``layers``: iterable of (name, n_peak, h_peak_km, scale_km,
    solar_sensitivity). ``cos_chi``: solar zenith cosine (scalar or
    broadcastable to h_km) — each layer is modulated by the Chapman
    sqrt(cos χ) factor raised to its sensitivity. ``plasmasphere_n0``:
    density of the exp(−(h−h_F2)/H_p) tail at the topmost peak (set ~1e10
    for a realistic topside; 0 disables).
    """
    total = jnp.zeros_like(jnp.asarray(h_km, jnp.result_type(float)))
    h_top = 0.0
    for (_, n_peak, h_peak, scale, sens) in layers:
        ne = chapman_ne(h_km, n_peak, h_peak, scale)
        if cos_chi is not None:
            ne = ne * solar_zenith_factor(cos_chi) ** sens
        total = total + ne
        h_top = max(h_top, h_peak)
    if plasmasphere_n0:
        # smooth onset (logistic ramp over ~60 km about the topmost peak)
        # so the tail adds no density step/gradient sheet at h_top that a
        # bent-ray tracer would refract on
        dh = h_km - h_top
        tail = plasmasphere_n0 * jnp.exp(
            -jnp.maximum(dh, 0.0) / plasmasphere_scale_km)
        total = total + tail * jax.nn.sigmoid(dh / 60.0)
    return total


def multi_chapman_field(grid: Grid3D, layers=DEFAULT_LAYERS, cos_chi=None,
                        plasmasphere_n0=0.0, plasmasphere_scale_km=1200.0,
                        curved=False, earth_radius_km=None):
    """Sample the multi-layer profile onto a Grid3D (z axis = plane height).

    Per-voxel ``cos_chi`` is supported (any shape broadcastable to
    ``grid.shape``, e.g. an (nx, ny, 1) ``frames.solar_cos_zenith_field``
    map), giving a horizontally varying day/night terminator across the
    grid. ``curved=True`` evaluates each voxel at its true altitude above
    the curved Earth (see ``chapman_field``).
    """
    if curved:
        h = altitude_field(grid, earth_radius_km)
        return multi_chapman_ne(h, layers, cos_chi, plasmasphere_n0,
                                plasmasphere_scale_km)
    z_axis = grid.origin[2] + grid.spacing[2] * jnp.arange(grid.shape[2])
    if cos_chi is None or jnp.ndim(cos_chi) == 0:
        prof = multi_chapman_ne(z_axis, layers, cos_chi, plasmasphere_n0,
                                plasmasphere_scale_km)
        return jnp.broadcast_to(prof[None, None, :], grid.shape)
    h = jnp.broadcast_to(z_axis[None, None, :], grid.shape)
    return multi_chapman_ne(h, layers, cos_chi, plasmasphere_n0,
                            plasmasphere_scale_km)


def background_ne_fn(n_peak=1.0e12, h_peak_km=350.0, scale_km=80.0,
                     cos_chi=None, curved=False, earth_radius_km=None,
                     site_height_km=0.0, layers=None,
                     plasmasphere_n0=0.0, plasmasphere_scale_km=1200.0):
    """Closed-form background field evaluator for the split-field tracer.

    Returns ``fn(points (R, 3) ENU km) -> (n_e (R,) [m⁻³], ∇n_e (R, 3)
    [m⁻³/km])`` with the gradient obtained by jax autodiff of the analytic
    profile — exact, gather-free, elementwise. Supports the single
    Chapman layer (default), a multi-Chapman stack (``layers`` as in
    ``multi_chapman_ne``), scalar solar-zenith modulation, and the
    curved-Earth altitude model (``altitude_field`` geometry evaluated
    pointwise). Per-column (terminator) cos_chi maps are not supported
    here — they are grid products; use the full-field tracer for
    horizontally-modulated backgrounds.

    This is the analytic half of ``geometry.fermat.trace_rays_split``:
    the background needs ZERO grid gathers, so only the (smaller,
    shallower-gradient) turbulent perturbation pays the tricubic gather,
    which is what lets the split tracer halve the integrator step count
    at solver-grade accuracy (round-3 study, PRECISION.md).
    """
    if cos_chi is not None and jnp.ndim(cos_chi) != 0:
        raise ValueError("background_ne_fn needs scalar cos_chi; "
                         "per-column terminator maps are grid products")
    # single-layer: scalar solar factor on N_peak (as chapman_field does);
    # multi-layer: per-layer factor**sensitivity with the plasmasphere
    # tail unmodulated — delegated to multi_chapman_ne so the split
    # background matches multi_chapman_field exactly
    factor = (1.0 if cos_chi is None
              else float(solar_zenith_factor(cos_chi)))
    cc = None if cos_chi is None else float(cos_chi)
    from .. import constants as _c
    r_earth = (_c.EARTH_RADIUS_KM if earth_radius_km is None
               else float(earth_radius_km))

    def ne_point(x):
        if curved:
            zc = r_earth + site_height_km + x[2]
            h = jnp.sqrt(x[0] * x[0] + x[1] * x[1] + zc * zc) - r_earth
        else:
            h = x[2]
        if layers is not None:
            return multi_chapman_ne(
                h, layers, cc, plasmasphere_n0, plasmasphere_scale_km)
        return factor * chapman_ne(h, n_peak, h_peak_km, scale_km)

    grad_point = jax.value_and_grad(ne_point)

    def fn(points):
        return jax.vmap(grad_point)(points)

    return fn


#: Vacuum floor of the log-parametrization m = log(n_e/K_NE) ≈ -85.2:
#: the ratio floor 1e-37 is a normal f32 number (no FTZ), far below any
#: physical density. ONE constant shared by ``log_parametrize`` and the
#: parametric profile fields (inversion/profile.py) so gridded and
#: parametric log-fields agree in the vacuum tail (ADVICE r3: the floors
#: had diverged by ~9 log units).
M_FLOOR = float(np.log(1e-37))


def log_parametrize(n_e):
    """m = log(n_e / K_NE), clipped away from -inf for vanishing density.

    The clip is applied to the *ratio*: clipping n_e before the division
    (the obvious form) fails in f32 — a clipped 1e-30 becomes 1e-41
    after /K_NE, which is subnormal and flushed to zero by XLA's CPU
    and accelerator backends alike, so deep Chapman tails (e.g. 25 km below a 420 km peak)
    came out -inf and NaN-poisoned every interpolation touching the
    bottom grid nodes. The floor is ``M_FLOOR`` = log(1e-37) ≈ -85.2."""
    return jnp.log(jnp.maximum(n_e / constants.K_NE, 1e-37))


def ne_from_log(m):
    """n_e = K_NE * exp(m)."""
    return constants.K_NE * jnp.exp(m)


def grid_enclosing_rays(antennas_enu, directions_enu,
                        max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
                        shape=(64, 64, 64), pad_km=25.0,
                        h_min_km=None) -> Grid3D:
    """Build a Grid3D that encloses every (antenna, direction) ray + padding.

    Host-side helper (numpy in, static Grid3D out) — the analogue of the
    reference's initial-model grid sizing (SURVEY.md §2: "builds initial
    TriCubic grid sized to enclose all rays + padding").
    """
    ants = np.atleast_2d(np.asarray(antennas_enu, np.float64))
    dirs = np.asarray(directions_enu, np.float64).reshape(-1, 3)
    ends = ants[:, None, :] + max_length_km * dirs[None, :, :]
    pts = np.concatenate([np.broadcast_to(ants[:, None, :], ends.shape)
                          .reshape(-1, 3), ends.reshape(-1, 3)], axis=0)
    lo = pts.min(axis=0) - pad_km
    hi = pts.max(axis=0) + pad_km
    if h_min_km is not None:
        lo[2] = min(lo[2], h_min_km)
    return Grid3D.from_bounds(lo, hi, shape)
