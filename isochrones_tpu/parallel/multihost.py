"""Multi-host (DCN) fleet sharding for independent fits.

The reference's multi-node story is ``scripts/batch_starfit``: a SLURM job
array that shards a folder list across nodes with awk/xargs — embarrassingly
parallel, zero inter-node communication (SURVEY §2.8c / §5 "distributed
backend"). The equivalent here keeps that shape: each host process owns
a contiguous shard of the work list and runs its fits on its local devices;
cross-host traffic is limited to ``jax.distributed`` control-plane setup (and
an optional completion barrier). Device-level sharding of a single fit lives
in :mod:`isochrones_tpu.parallel` (mesh/pjit); this module covers the host level.

Environment conventions follow ``jax.distributed.initialize``: explicit
arguments win, else JAX's cluster auto-detection (SLURM, …), else
the ``ISOCHRONES_TPU_{COORDINATOR,NUM_PROCESSES,PROCESS_ID}`` variables set by
the ``batch-starfit --multihost`` launcher.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

__all__ = [
    "initialize_distributed",
    "process_shard",
    "fleet_map",
]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
):
    """Initialize the JAX distributed runtime for a multi-host fleet.

    Returns ``(process_id, num_processes)``. Safe to call in a single-process
    run (returns ``(0, 1)`` without touching the distributed runtime when no
    coordinator is configured anywhere).
    """
    import jax

    coordinator_address = coordinator_address or os.getenv("ISOCHRONES_TPU_COORDINATOR")
    if num_processes is None and os.getenv("ISOCHRONES_TPU_NUM_PROCESSES"):
        num_processes = int(os.environ["ISOCHRONES_TPU_NUM_PROCESSES"])
    if process_id is None and os.getenv("ISOCHRONES_TPU_PROCESS_ID"):
        process_id = int(os.environ["ISOCHRONES_TPU_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        # plain single-host run — possibly under SLURM auto-detection
        try:
            if jax.process_count() > 1:
                return jax.process_index(), jax.process_count()
        except Exception:
            pass
        return 0, 1

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    return jax.process_index(), jax.process_count()


def process_shard(
    items: Sequence,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
) -> list:
    """This process's contiguous shard of a work list (folders, catalog rows).

    Deterministic, disjoint, and complete across processes — the awk/xargs
    split of ``scripts/batch_starfit`` without the temp files. Defaults to the
    live ``jax.process_index()/process_count()``.
    """
    if process_id is None or num_processes is None:
        import jax

        process_id = jax.process_index() if process_id is None else process_id
        num_processes = jax.process_count() if num_processes is None else num_processes
    items = list(items)
    n = len(items)
    base, extra = divmod(n, num_processes)
    start = process_id * base + min(process_id, extra)
    stop = start + base + (1 if process_id < extra else 0)
    return items[start:stop]


def fleet_map(fn, items: Sequence, barrier: bool = True, timeout_s: float = 86400.0, **dist_kwargs) -> list:
    """Run ``fn(item)`` over this process's shard of ``items``.

    The whole-fleet pattern for independent fits: call on every host with the
    same ``items``; each host processes only its shard. With ``barrier=True``
    all processes synchronize at the end (so a driver can safely gather
    outputs from a shared filesystem afterwards); ``timeout_s`` bounds the
    wait for stragglers.
    """
    pid, nproc = initialize_distributed(**dist_kwargs)
    results = [fn(item) for item in process_shard(items, pid, nproc)]
    if barrier and nproc > 1:
        _fleet_barrier("isochrones_tpu_fleet_map_end", timeout_s=timeout_s)
    return results


def _fleet_barrier(name: str, timeout_s: float = 86400.0):
    """Cross-process barrier via the jax.distributed COORDINATION service.

    Deliberately NOT a device collective (`sync_global_devices`): a
    collective creates its transport pairs lazily at first use with a short
    connect timeout, so a barrier first reached minutes apart (shards of
    independent fits routinely finish minutes apart) times out. The
    coordination-service barrier is control-plane gRPC with an explicit
    timeout and no data-plane setup.
    """
    from jax._src import distributed

    client = getattr(distributed.global_state, "client", None)
    if client is None:
        return  # single-process run
    client.wait_at_barrier(name, timeout_in_ms=int(timeout_s * 1000))
