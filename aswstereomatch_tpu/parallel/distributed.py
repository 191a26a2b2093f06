"""Multi-host runtime (SURVEY.md sections 2.2 / 5 "distributed backend").

The reference has no communication layer at all; the JAX equivalent of an
MPI/NCCL backend is ``jax.distributed.initialize`` + GSPMD over a global
mesh — no custom transport:

  - intra-host traffic (halo exchange, D-shard combines) uses the
    collectives in parallel/tiling.py and parallel/dshard.py;
  - cross-host traffic is only the batch ("data") axis — embarrassingly
    parallel pair dispatch, plus result gathering.

``initialize()`` wires up the process group (coordinator address, process
count and id passed explicitly); ``global_mesh`` builds the (data, tile)
mesh over all global devices with hosts mapped to the data axis (so "tile"
neighbors stay intra-host whenever tile <= local_device_count);
``run_batch_distributed`` shards a batch of
pairs across it and returns the host-local result shards.

Elastic recovery (SURVEY section 5): stereo pairs are stateless, so failure
handling is re-dispatch — pair the batch runner with utils.manifest to
resume a sweep after relaunch; there is deliberately no in-band state
machine to recover.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import numpy as np

from ..config import StereoConfig
from . import mesh as mesh_lib
from . import tiling


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up the multi-host runtime.

    Pass ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``: nothing on a plain GPU host describes the cluster to
    JAX.  Loopback multi-process CPU tests use the same arguments
    (tests/test_distributed.py).
    """
    if jax.process_count() > 1:
        return  # already initialized
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def global_mesh(tile: Optional[int] = None):
    """(data, tile) mesh over all global devices.

    ``tile`` defaults to the per-host device count so halo exchange stays on
    ICI and the data axis maps across hosts (DCN).
    """
    n = jax.device_count()
    if tile is None:
        tile = min(jax.local_device_count(), n)
    while n % tile:
        tile -= 1
    return mesh_lib.build_mesh(data=n // tile, tile=tile)


def run_batch_distributed(
    lefts: np.ndarray,
    rights: np.ndarray,
    cfg: StereoConfig,
    device_mesh=None,
):
    """Shard a (B, H, W[, 3]) batch over (data, tile) and match it.

    Returns the global jax.Array result; each host addresses its own batch
    shard (``result.addressable_shards``).  B must divide by the data axis.
    """
    if device_mesh is None:
        device_mesh = global_mesh()
    lefts, rights = tiling.shard_batch_arrays(
        (np.asarray(lefts), np.asarray(rights)), device_mesh
    )
    fn = jax.jit(
        functools.partial(
            tiling.match_batch_sharded, cfg=cfg, device_mesh=device_mesh
        )
    )
    return fn(lefts, rights)


def weak_scaling_report(times_by_n: dict) -> dict:
    """Weak-scaling efficiency table from {n_chips: seconds_per_batch} where
    the batch grows proportionally with n (BASELINE target: >= 0.8)."""
    if not times_by_n:
        return {}
    base_n = min(times_by_n)
    base_t = times_by_n[base_n]
    return {
        n: round(base_t / t, 4) if t > 0 else float("nan")
        for n, t in sorted(times_by_n.items())
    }
