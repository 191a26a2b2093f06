"""Device-mesh construction (SURVEY.md section 2.2).

The reference is single-process/single-thread with no communication layer;
the JAX equivalent of a comm backend is XLA collectives over a named
``jax.sharding.Mesh`` — a plain (data, tile) grid; the GPUs of one host are
joined all to all, so no device order matters for neighbor traffic:

  - axis "data": independent stereo pairs (batch) — DP; no intra-step
    communication.
  - axis "tile": spatial image tiles — the sequence/context-parallel analog;
    halo exchange via ``ppermute`` (parallel/tiling.py).

``build_mesh`` works with however many devices are visible (real GPUs or
``--xla_force_host_platform_device_count`` fakes for tests).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh

DATA_AXIS = "data"
TILE_AXIS = "tile"


def build_mesh(
    data: int = 1,
    tile: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Mesh of shape (data, tile) over the given (or all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    need = data * tile
    if len(devices) < need:
        raise ValueError(
            f"mesh ({data} x {tile}) needs {need} devices, have {len(devices)}"
        )
    arr = np.array(devices[:need]).reshape(data, tile)
    return Mesh(arr, (DATA_AXIS, TILE_AXIS))


def single_device_mesh() -> Mesh:
    return build_mesh(1, 1)


def mesh_from_config(cfg) -> Mesh:
    """Mesh for a StereoConfig's declared (mesh_data, mesh_tile) layout."""
    return build_mesh(data=cfg.mesh_data, tile=cfg.mesh_tile)
