"""High-level sharded entry point driven by the config's declared layout.

``sharded_match_fn(cfg)`` turns a StereoConfig whose mesh fields declare a
multi-device layout (mesh_data x mesh_tile, tile_axis in {y, x, d}) into the
matching callable over the corresponding function from tiling/dshard — the
config-driven front door the CLI and deployment code use, so the layout
lives in one place (the config hash covers it).
"""

from __future__ import annotations

import functools

import warnings

import jax

from ..config import StereoConfig
from ..models import pipeline
from . import dshard, mesh as mesh_lib, tiling


def layout_fits(cfg: StereoConfig) -> bool:
    """True iff cfg declares a >1-device mesh that fits the visible devices
    (public: callers routing between the single-device matcher and the
    sharded jit need exactly this predicate)."""
    need = cfg.mesh_data * cfg.mesh_tile
    if need <= 1:
        return False
    if need > jax.device_count():
        warnings.warn(
            f"config declares a {cfg.mesh_data}x{cfg.mesh_tile} mesh but only "
            f"{jax.device_count()} device(s) are visible; running unsharded"
        )
        return False
    return True


def sharded_match_fn(cfg: StereoConfig):
    """(left, right) -> disparity callable honoring cfg's mesh layout.

    Falls back to the single-device pipeline when the layout is 1x1 or does
    not fit the visible devices (with a warning).
    """
    if not layout_fits(cfg):
        return functools.partial(pipeline.match_pair, cfg=cfg)
    m = mesh_lib.mesh_from_config(cfg)
    fn = {
        "y": tiling.match_pair_tiled,
        "x": tiling.match_pair_tiled_x,
        "d": dshard.match_pair_dsharded,
    }[cfg.tile_axis]
    return functools.partial(fn, cfg=cfg, device_mesh=m)


def sharded_batch_fn(cfg: StereoConfig):
    """(lefts, rights) -> disparities callable honoring cfg's mesh layout.

    Batch mode shards "data" x y-tiles; for x/d tile_axis the per-pair
    function is vmapped over the batch via the single-pair path.
    """
    if not layout_fits(cfg):
        return functools.partial(pipeline.match_batch, cfg=cfg)
    m = mesh_lib.mesh_from_config(cfg)
    if cfg.tile_axis == "y":
        return functools.partial(tiling.match_batch_sharded, cfg=cfg, device_mesh=m)
    single = sharded_match_fn(cfg)
    return lambda lefts, rights: jax.vmap(single)(lefts, rights)
