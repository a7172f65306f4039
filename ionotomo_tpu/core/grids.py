"""Regular 3D grid specification.

Design: the grid is a static-shape, dynamic-extent object.  The
voxel array itself is *not* stored here — fields are plain ``jnp`` arrays of
shape ``grid.shape`` passed alongside the ``Grid3D`` spec, so the same spec
can describe n_e cubes, log-density models, priors and gradients without
re-wrapping (contrast the reference's ``TriCubic`` object which owns its
array and its HDF5 persistence; see SURVEY.md §2 "TriCubic interpolator").
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Grid3D:
    """Axis-aligned regular grid.

    ``origin``/``spacing`` are data (traced) so the same compiled program can
    serve any placement; ``shape`` is metadata (static) so array shapes stay
    known to XLA.
    """

    origin: jax.Array   # (3,) physical coordinate of voxel (0,0,0) [km]
    spacing: jax.Array  # (3,) voxel pitch per axis [km]
    shape: Tuple[int, int, int] = dataclasses.field(
        metadata=dict(static=True)
    )

    @staticmethod
    def create(origin, spacing, shape) -> "Grid3D":
        return Grid3D(
            origin=jnp.asarray(origin, jnp.float32),
            spacing=jnp.asarray(spacing, jnp.float32),
            shape=tuple(int(s) for s in shape),
        )

    @staticmethod
    def from_bounds(lo, hi, shape) -> "Grid3D":
        lo = jnp.asarray(lo, jnp.float32)
        hi = jnp.asarray(hi, jnp.float32)
        shape = tuple(int(s) for s in shape)
        n = jnp.asarray([max(s - 1, 1) for s in shape], jnp.float32)
        return Grid3D(origin=lo, spacing=(hi - lo) / n, shape=shape)

    @property
    def num_voxels(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz

    def axes(self):
        """Per-axis coordinate vectors (host/numpy friendly)."""
        return tuple(
            self.origin[d] + self.spacing[d] * jnp.arange(self.shape[d])
            for d in range(3)
        )

    def upper(self) -> jax.Array:
        n = jnp.asarray([s - 1 for s in self.shape], jnp.float32)
        return self.origin + self.spacing * n

    def world_to_index(self, points: jax.Array) -> jax.Array:
        """Map physical points (..., 3) to fractional voxel indices."""
        return (points - self.origin) / self.spacing

    def meshgrid(self):
        """Dense (nx,ny,nz,3) coordinate lattice. Host-side / setup only."""
        ax = [np.asarray(a) for a in self.axes()]
        X, Y, Z = np.meshgrid(*ax, indexing="ij")
        return np.stack([X, Y, Z], axis=-1)


def save_field(path, grid: Grid3D, field, name="field", attrs=None):
    """Persist (grid, field) to HDF5 — the reference TriCubic's save/load
    capability (SURVEY.md §2) as free functions over (Grid3D, array)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("grid/origin", data=np.asarray(grid.origin))
        f.create_dataset("grid/spacing", data=np.asarray(grid.spacing))
        f.create_dataset("grid/shape",
                         data=np.asarray(grid.shape, np.int64))
        f.create_dataset(name, data=np.asarray(field))
        f.attrs["field_name"] = name
        for k, v in (attrs or {}).items():
            f.attrs[k] = v


def load_field(path):
    """Returns (Grid3D, field ndarray, attrs dict)."""
    import h5py

    with h5py.File(path, "r") as f:
        grid = Grid3D.create(f["grid/origin"][:], f["grid/spacing"][:],
                             tuple(int(s) for s in f["grid/shape"][:]))
        name = f.attrs.get("field_name", "field")
        field = f[name][:]
        attrs = {k: f.attrs[k] for k in f.attrs if k != "field_name"}
    return grid, field, attrs
