"""Multi-device parallelism (SPMD over `jax.sharding.Mesh`).

The reference's distributed layer is MPI rank-parallel likelihood fan-out for
MultiNest plus schwimmbad pools and SLURM job arrays (SURVEY §2.8). All of it
is embarrassingly parallel over walkers/live-points/stars, so the device
equivalent is pure data-parallel sharding:

* walkers/live points shard along a ``walkers`` mesh axis — the vmapped
  lnpost (grid gathers + Gaussian terms, the hot kernel) runs on each device's
  slice with zero communication;
* the ensemble stretch move needs the complementary half-ensemble, which XLA
  materializes with a tiny all-gather of the (n_walkers, n_params) state —
  negligible next to the lnpost gathers;
* cluster likelihoods shard along a ``stars`` axis (each device owns a block of
  stars' (Neep x Neep) lnlike grids; the total is a psum of scalars);
* fleets of independent fits (the ``batch_starfit`` role) shard across hosts —
  no collectives at all.

Grids (:class:`~isochrones_tpu.ops.interp.GridData` pytrees) are replicated:
they are read-only, fit in device memory in f32/f64, and every walker gathers from
random locations, so replication beats sharding + all-to-all.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "default_mesh",
    "shard_batch",
    "replicate",
    "sharded_lnpost",
    "pad_to_multiple",
    "mesh_constrain_leading",
    "mesh_wrap_fn",
]


def default_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("walkers",)) -> Mesh:
    """1-d (or reshaped N-d) mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = np.array(devs[:n_devices])
    if len(axis_names) == 1:
        shape = (n_devices,)
    else:
        # factor devices as evenly as possible over leading axes
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    return Mesh(devs.reshape(shape), axis_names)


def shard_batch(x: jnp.ndarray, mesh: Mesh, axis: str = "walkers") -> jnp.ndarray:
    """Place ``x`` with its leading axis sharded over ``axis``."""
    spec = P(axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (e.g. GridData) across all mesh devices."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, fill=np.nan):
    """Pad the batch axis so it divides evenly across devices. Returns
    (padded, n_valid)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, rem)
    return np.pad(x, pad_width, constant_values=fill), n


def sharded_lnpost(lnpost_batch, mesh: Mesh, axis: str = "walkers"):
    """Wrap a jittable (B, n_params) -> (B,) posterior so batches shard over
    ``axis``. Pure data parallel: no collectives inside — each chip evaluates
    its walker slice independently (the role MPI plays for MultiNest,
    reference starmodel.py:755-762)."""
    in_spec = NamedSharding(mesh, P(axis, None))
    out_spec = NamedSharding(mesh, P(axis))
    return jax.jit(lnpost_batch, in_shardings=(in_spec,), out_shardings=out_spec)


def mesh_constrain_leading(tree, mesh: Mesh):
    """Constrain every array in ``tree`` to shard its LEADING axis over
    ``mesh``'s first axis (independent runs / chains / stars axes — the
    fan-out axes every fit engine shards)."""
    ax = mesh.axis_names[0]

    def one(x):
        if x is None:
            return None
        spec = P(ax, *([None] * (x.ndim - 1)))
        return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(one, tree, is_leaf=lambda x: x is None)


def mesh_wrap_fn(fn, mesh: Mesh):
    """Tracer-guarded sharding wrapper: constrain the leading axis of every
    array argument AND result of ``fn`` over ``mesh``'s first axis. The one
    mesh-plumbing helper shared by every fit engine (nested / NUTS /
    ensemble / batch) — keep the tracer guard here, in one place: eager
    (init-time) calls pass through unwrapped because
    ``with_sharding_constraint`` outside jit is a ``device_put`` that
    requires divisible batch sizes, while under jit GSPMD pads any size."""

    def wrapped(*args):
        if not any(
            isinstance(a, jax.core.Tracer) for a in jax.tree_util.tree_leaves(args)
        ):
            return fn(*args)
        args = mesh_constrain_leading(args, mesh)
        return mesh_constrain_leading(fn(*args), mesh)

    return wrapped
