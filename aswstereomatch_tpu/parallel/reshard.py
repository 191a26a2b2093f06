"""Ulysses-analog all_to_all reshard: spatial-sharded <-> disparity-sharded.

SURVEY.md section 2.2 lists the optional layout switch between the
*spatial*-sharded layout that cost construction likes (each device holds all
D for a column band) and the *disparity*-sharded layout that WTA combination
likes (each device holds a D-slab for all columns).  This is the stereo
equivalent of DeepSpeed-Ulysses' sequence<->head all_to_all, built on
``jax.lax.all_to_all`` over the mesh "tile" axis.

In this engine the end-to-end paths avoid the reshard (the x-tiled layout
merges per-shard winners; dshard.py aggregates slabs directly), so this
component
exists for pipelines that *do* materialize slabs — e.g. exporting an
x-sharded aggregated volume for disparity-sharded analysis — and to
document/validate the collective choreography.  Round-trip and layout
correctness are pinned by tests on the virtual mesh.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from . import mesh as mesh_lib


def x_to_d(vol_xsharded: jnp.ndarray, device_mesh: Mesh) -> jnp.ndarray:
    """(H, W/n per shard, D) x-sharded volume -> (H, W, D/n) d-sharded.

    Global view: input sharded P(None, "tile", None), output
    P(None, None, "tile").  One all_to_all over ICI.
    """
    axis = mesh_lib.TILE_AXIS

    @functools.partial(
        shard_map,
        mesh=device_mesh,
        in_specs=P(None, axis, None),
        out_specs=P(None, None, axis),
        check_vma=False,
    )
    def go(block):  # (H, ws, D) -> (H, ws*n, D/n)
        # tiled all_to_all: D-chunk j of the local columns goes to shard j;
        # we receive our D-chunk of everyone's columns, concatenated in
        # shard (= global column) order.
        return lax.all_to_all(
            block, axis, split_axis=2, concat_axis=1, tiled=True
        )

    return go(vol_xsharded)


def d_to_x(vol_dsharded: jnp.ndarray, device_mesh: Mesh) -> jnp.ndarray:
    """Inverse reshard: (H, W, D/n per shard) -> (H, W/n, D)."""
    axis = mesh_lib.TILE_AXIS

    @functools.partial(
        shard_map,
        mesh=device_mesh,
        in_specs=P(None, None, axis),
        out_specs=P(None, axis, None),
        check_vma=False,
    )
    def go(block):  # (H, W, ds) -> (H, W/n, ds*n)
        return lax.all_to_all(
            block, axis, split_axis=1, concat_axis=2, tiled=True
        )

    return go(vol_dsharded)
