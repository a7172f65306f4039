"""Multi-chip execution: ray-axis sharding over a device mesh.

Design (SURVEY.md §2.1–2.2, §5.7–5.8): the reference's dask fan-out over
ray chunks becomes single-program SPMD — a 1-D mesh over the ray axis, the
voxel grid **replicated** (256³ f32 = 64 MiB fits every chip), rays sharded.
The only cross-chip traffic in the inner loop is the psum of adjoint/
gradient contributions and CG inner products (NVLink between the cards
of one host). Kept deliberately thin: these helpers build
meshes/shardings; solver code stays sharding-
agnostic because XLA's SPMD partitioner propagates the annotations through
jit (gather stays local to the replicated grid; the vjp scatter-add
all-reduces automatically).
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAY_AXIS = "rays"


def ray_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices, axis name 'rays'."""
    devices = devices if devices is not None else jax.devices()
    return jax.make_mesh((len(devices),), (RAY_AXIS,), devices=devices)


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (ray) axis."""
    return NamedSharding(mesh, P(RAY_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


MEMBER_AXIS = "members"


def member_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices, axis name 'members' — the
    EnKF's per-realization (P3) parallelism across chips: each device
    carries n_members/n_devices members end-to-end (advect + anchor +
    Krylov member update all member-local); the only cross-chip traffic
    is the grid-sized ensemble mean/std psum once per step and the
    scalar reductions of the shared wind refinement. Near-linear scaling
    when n_members % n_devices == 0 (required — members are not padded:
    a phantom member would bias the ensemble mean)."""
    devices = devices if devices is not None else jax.devices()
    return jax.make_mesh((len(devices),), (MEMBER_AXIS,), devices=devices)


def member_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (member) axis of an (n_members, *grid) ensemble."""
    return NamedSharding(mesh, P(MEMBER_AXIS))


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def shard_ray_batch(mesh: Mesh, *arrays):
    """Pad the leading axis to a multiple of the mesh size and place each
    array with the ray axis sharded. Returns (padded arrays, valid_count).

    Padding replicates the last element so padded rays are valid geometry
    (their results are sliced away / masked by the caller).
    """
    nd = mesh.devices.size
    out = []
    n = arrays[0].shape[0]
    n_pad = pad_to_multiple(n, nd)
    sh = ray_sharding(mesh)
    for a in arrays:
        if n_pad != n:
            pad = jnp.broadcast_to(a[-1:], (n_pad - n,) + a.shape[1:])
            a = jnp.concatenate([a, pad], axis=0)
        out.append(jax.device_put(a, sh))
    return out, n


def replicate(mesh: Mesh, *arrays):
    """Place arrays fully replicated on the mesh."""
    sh = replicated(mesh)
    return [jax.device_put(a, sh) for a in arrays]
