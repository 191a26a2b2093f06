"""Spatial tiling with halo exchange — the sequence-parallel analog.

Rectified stereo pairs are sharded as image tiles with halo exchange across
the devices of a mesh.  This module shards the image row (y) axis over the
mesh "tile" axis under ``shard_map``:

  - y-tiling is the preferred layout (SURVEY.md section 7 "weak scaling"):
    every stage's x-dependencies (cost x-d access, LR gather, per-row hole
    fill) stay shard-local, so the only communication is a ring ``ppermute``
    of ``halo_y = window_radius (+1 for median)`` image rows per neighbor —
    independent of D.  x-tiling would additionally move a D_max-wide strip of
    the right image.

  - Exactness invariant (tested): tiled output == untiled output
    **bit-for-bit**.  Three mechanisms make this hold:
      1. boundary shards overwrite their missing halo with edge-replicated
         rows, which reproduces the untiled replicate-border taps exactly;
      2. each shard computes disparity for its rows plus one extra row per
         side, so the final 3x3 median sees real neighbors;
      3. the median's input rows are indexed by *global-row-clamped* indices,
         reproducing the untiled edge clamp at the true image boundary (also
         what makes bottom-padding to a row-multiple exact for real rows).

All collective choreography is here; the per-tile compute is the unchanged
single-device pipeline (models/pipeline.py) — same ops, same f32 order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import StereoConfig
from ..models import pipeline
from . import mesh as mesh_lib


def _halo_rows(cfg: StereoConfig) -> int:
    """Image rows of halo each side (see StereoConfig.halo_y)."""
    return cfg.halo_y


def _exchange_halos(block: jnp.ndarray, halo: int, axis: str) -> jnp.ndarray:
    """Concatenate neighbor halos onto a row block: (rows, ...) ->
    (halo + rows + halo, ...).  Boundary shards take edge-replicated rows."""
    n = lax.axis_size(axis)
    idx = lax.axis_index(axis)
    if n == 1:
        top = jnp.repeat(block[:1], halo, axis=0)
        bot = jnp.repeat(block[-1:], halo, axis=0)
        return jnp.concatenate([top, block, bot], axis=0)
    # shard i's bottom rows become shard i+1's top halo, and vice versa.
    from_above = lax.ppermute(
        block[-halo:], axis, [(i, i + 1) for i in range(n - 1)]
    )
    from_below = lax.ppermute(
        block[:halo], axis, [(i, i - 1) for i in range(1, n)]
    )
    edge_top = jnp.repeat(block[:1], halo, axis=0)
    edge_bot = jnp.repeat(block[-1:], halo, axis=0)
    from_above = jnp.where(idx == 0, edge_top, from_above)
    from_below = jnp.where(idx == n - 1, edge_bot, from_below)
    return jnp.concatenate([from_above, block, from_below], axis=0)


def _match_tile(
    left_ext: jnp.ndarray,
    right_ext: jnp.ndarray,
    cfg: StereoConfig,
    halo: int,
    rows: int,
    true_h: int,
    axis: str,
) -> jnp.ndarray:
    """Owned-row disparity for one shard's halo-extended tile.

    Thin wrapper over the shared band computation (pipeline.tile_disparity)
    with the band offset taken from the shard's mesh position.
    """
    start = lax.axis_index(axis) * rows  # global index of first owned row
    return pipeline.tile_disparity(
        left_ext, right_ext, cfg, halo, rows, true_h, start
    )


def _reject_global_aggregation(cfg: StereoConfig) -> None:
    """Scanline-global modes cannot tile: SGM's path recurrences propagate
    across the whole image, so no finite halo reproduces the untiled
    result.  Reject instead of silently breaking the bit-exactness
    invariant (unsharded jnp serves these configs)."""
    if cfg.aggregation == "sgm":
        raise ValueError(
            "aggregation='sgm' propagates globally along scanlines and "
            "does not support spatial tiling; run unsharded (jnp backend)"
        )


def match_pair_tiled(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: StereoConfig,
    device_mesh: Mesh,
) -> jnp.ndarray:
    """Single pair, y-sharded over the mesh "tile" axis.  Jit-friendly.

    Pads H to a multiple of the tile count (bottom, edge rows) and trims;
    real rows are bit-identical to the untiled pipeline.
    """
    _reject_global_aggregation(cfg)
    axis = mesh_lib.TILE_AXIS
    n = device_mesh.shape[axis]
    h = left.shape[0]
    pad = (-h) % n
    if pad:
        widths = [(0, pad)] + [(0, 0)] * (left.ndim - 1)
        left = jnp.pad(left, widths, mode="edge")
        right = jnp.pad(right, widths, mode="edge")
    rows = left.shape[0] // n
    halo = _halo_rows(cfg)
    if rows < halo:
        raise ValueError(
            f"{rows} rows/shard < halo {halo}; use fewer tile shards"
        )

    img_spec = P(axis) if left.ndim == 2 else P(axis, None, None)

    @functools.partial(
        shard_map,
        mesh=device_mesh,
        in_specs=(img_spec, img_spec),
        out_specs=P(axis, None),
        check_vma=False,
    )
    def run(l_blk, r_blk):
        l_ext = _exchange_halos(l_blk, halo, axis)
        r_ext = _exchange_halos(r_blk, halo, axis)
        return _match_tile(l_ext, r_ext, cfg, halo, rows, h, axis)

    out = run(left, right)
    return out[:h]


def match_batch_sharded(
    lefts: jnp.ndarray,
    rights: jnp.ndarray,
    cfg: StereoConfig,
    device_mesh: Mesh,
) -> jnp.ndarray:
    """Batched throughput mode: batch over "data" x rows over "tile".

    (B, H, W[, 3]) inputs; the batch axis shards over "data" (no
    intra-step collectives), rows over "tile" (halo exchange).
    """
    axis = mesh_lib.TILE_AXIS
    daxis = mesh_lib.DATA_AXIS
    nd = device_mesh.shape[daxis]
    if device_mesh.shape[axis] > 1:
        # Pure data-axis sharding keeps every pair's scanlines intact, so
        # SGM batches shard fine at tile=1; only the spatial split is
        # rejected.
        _reject_global_aggregation(cfg)
    nt = device_mesh.shape[axis]
    b, h = lefts.shape[0], lefts.shape[1]
    if b % nd:
        raise ValueError(f"batch {b} not divisible by data axis {nd}")
    if cfg.aggregation == "sgm":
        # Data-only layout (nt == 1, enforced above): each shard runs the
        # UNSHARDED pipeline on its local pairs — no y halos, because even
        # edge-replicated halo rows would perturb the global scanline
        # recurrence (the vertical passes would start from replica rows).
        ispec = P(daxis) if lefts.ndim == 3 else P(daxis, None, None, None)

        @functools.partial(
            shard_map,
            mesh=device_mesh,
            in_specs=(ispec, ispec),
            out_specs=P(daxis, None, None),
            check_vma=False,
        )
        def run_sgm(l_blk, r_blk):
            return pipeline.match_batch(l_blk, r_blk, cfg)

        return run_sgm(lefts, rights)
    pad = (-h) % nt
    if pad:
        widths = [(0, 0), (0, pad)] + [(0, 0)] * (lefts.ndim - 2)
        lefts = jnp.pad(lefts, widths, mode="edge")
        rights = jnp.pad(rights, widths, mode="edge")
    rows = lefts.shape[1] // nt
    halo = _halo_rows(cfg)
    if rows < halo:
        raise ValueError(
            f"{rows} rows/shard < halo {halo}; use fewer tile shards"
        )

    spec = (
        P(daxis, axis) if lefts.ndim == 3 else P(daxis, axis, None, None)
    )

    @functools.partial(
        shard_map,
        mesh=device_mesh,
        in_specs=(spec, spec),
        out_specs=P(daxis, axis, None),
        check_vma=False,
    )
    def run(l_blk, r_blk):
        # Halo exchange carries the whole local batch in one collective.
        l_ext = _exchange_halos(jnp.moveaxis(l_blk, 1, 0), halo, axis)
        r_ext = _exchange_halos(jnp.moveaxis(r_blk, 1, 0), halo, axis)
        l_ext = jnp.moveaxis(l_ext, 0, 1)
        r_ext = jnp.moveaxis(r_ext, 0, 1)
        fn = lambda l, r: _match_tile(l, r, cfg, halo, rows, h, axis)
        return jax.vmap(fn)(l_ext, r_ext)

    out = run(lefts, rights)
    return out[:, :h]


def shard_batch_arrays(arrays, device_mesh: Mesh):
    """device_put a pytree of (B, H, ...) arrays with data x tile sharding."""
    def put(a):
        spec = (
            P(mesh_lib.DATA_AXIS, mesh_lib.TILE_AXIS)
            if a.ndim <= 3
            else P(mesh_lib.DATA_AXIS, mesh_lib.TILE_AXIS, None, None)
        )
        return jax.device_put(a, NamedSharding(device_mesh, spec))

    return jax.tree_util.tree_map(put, arrays)


# ---------------------------------------------------------------------------
# x-axis tiling — the ring / D_max-halo layout (SURVEY.md section 2.2 SP row)
# ---------------------------------------------------------------------------

def _exchange_halos_x(block: jnp.ndarray, hl: int, hr: int, axis: str) -> jnp.ndarray:
    """Column halo exchange on the last axis: (..., ws) -> (..., hl+ws+hr).

    The left halo carries ``hl`` columns from the previous shard (for the
    right-image stack this is the aggregation radius + D_max strip — the
    ring-attention-shaped exchange); boundary shards substitute edge
    replicas, which equals the virtual padded plane.
    """
    n = lax.axis_size(axis)
    idx = lax.axis_index(axis)

    def edge(sl, count):
        return jnp.repeat(sl, count, axis=-1)

    if n == 1:
        return jnp.concatenate(
            [edge(block[..., :1], hl), block, edge(block[..., -1:], hr)], axis=-1
        )
    from_prev = lax.ppermute(
        block[..., -hl:], axis, [(i, i + 1) for i in range(n - 1)]
    )
    from_next = lax.ppermute(
        block[..., :hr], axis, [(i, i - 1) for i in range(1, n)]
    )
    from_prev = jnp.where(idx == 0, edge(block[..., :1], hl), from_prev)
    from_next = jnp.where(idx == n - 1, edge(block[..., -1:], hr), from_next)
    return jnp.concatenate([from_prev, block, from_next], axis=-1)


def match_pair_tiled_x(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: StereoConfig,
    device_mesh: Mesh,
) -> jnp.ndarray:
    """Single pair, x-sharded over the mesh "tile" axis (ASW configs).

    Per shard: the left channel stack travels with an r-column halo, the
    right stack with an (r + D_max - 1)-column left halo (the "sequence
    length" analog of SURVEY section 5); cost+ASW+WTA are computed locally
    from real neighbor columns; right-view partial argmins are merged with
    the next shard's (D-1)-column strip (strict-<, preserving first-min);
    the small per-view winner planes are then all-gathered so the x-global
    post-processing stages (LR gather along x, row fill, median) run
    replicated — bit-identical to the untiled pipeline.
    """
    _reject_global_aggregation(cfg)
    from ..ops import aggregate, postprocess, preprocess
    from ..ops import wta as wta_ops

    if cfg.aggregation not in ("asw", "box"):
        raise ValueError("x-tiling covers the asw/box aggregations")
    axis = mesh_lib.TILE_AXIS
    n = device_mesh.shape[axis]
    r = cfg.window_radius
    D = cfg.max_disparity
    hl_right, hr = cfg.halo_x  # right-stack halos: (r + D - 1, r)
    h, w = left.shape[:2]
    pad = (-w) % n
    ws = (w + pad) // n
    if hl_right > ws:
        raise ValueError(
            f"right-image halo {hl_right} exceeds {ws} cols/shard; "
            "use fewer x-shards"
        )

    ls = preprocess.channel_stack(left)
    rs = preprocess.channel_stack(right)
    if pad:
        widths = ((0, 0), (0, 0), (0, pad))
        ls = jnp.pad(ls, widths, mode="edge")
        rs = jnp.pad(rs, widths, mode="edge")

    spec = P(None, None, axis)

    @functools.partial(
        shard_map,
        mesh=device_mesh,
        in_specs=(spec, spec),
        out_specs=P(None, axis),
        check_vma=False,
    )
    def run(l_blk, r_blk):
        k = lax.axis_index(axis)
        x0 = k * ws  # global column of this shard's first owned column
        l_ext = _exchange_halos_x(l_blk, hr, hr, axis)
        r_ext = _exchange_halos_x(r_blk, hl_right, hr, axis)

        if cfg.aggregation == "box":
            vol_ext = aggregate.cost_volume_from_stacks(l_ext, r_ext, cfg)
            vol = aggregate.aggregate_box(vol_ext, cfg)
        else:
            vol = aggregate.aggregate_asw_from_stacks(l_ext, r_ext, cfg)
        outs = wta_ops.wta_with_triple(vol)  # local (H, ws) planes
        if cfg.uniqueness_ratio > 0:
            # per-pixel over the full d row — position-independent, so
            # tiled == untiled stays bit-exact
            outs["ubest"] = wta_ops.second_best_excl_neighbors(
                vol, outs["bestd"]
            )

        # Right-view partial over x' in [x0 - (D-1), x0 + ws): candidate
        # (x', d) lives here iff left pixel x'+d is owned and real.
        xg = x0 + jnp.arange(ws)[None, :, None]  # global owned x
        vol_r = jnp.where(xg <= w - 1, vol, jnp.inf)  # exclude padding
        jj = jnp.arange(ws + D - 1)[:, None]  # partial-buffer index
        dd = jnp.arange(D)[None, :]
        src = jj - (D - 1) + dd  # local left col feeding (j, d)
        valid = (src >= 0) & (src < ws)
        gath = jnp.take_along_axis(
            vol_r,
            jnp.broadcast_to(
                jnp.clip(src, 0, ws - 1)[None], (h, ws + D - 1, D)
            ),
            axis=1,
        )
        gath = jnp.where(valid[None], gath, jnp.inf)
        rpart_c = jnp.min(gath, axis=-1)
        rpart_d = jnp.argmin(gath, axis=-1).astype(jnp.int32)
        own_c = rpart_c[:, D - 1 :]
        own_d = rpart_d[:, D - 1 :]
        strip_c = rpart_c[:, : D - 1]
        strip_d = rpart_d[:, : D - 1]

        # Merge with the next shard's left strip (its candidates have
        # strictly larger d for the same x', so strict-< keeps first-min).
        if n > 1 and D > 1:
            nb_c = lax.ppermute(strip_c, axis, [(i, i - 1) for i in range(1, n)])
            nb_d = lax.ppermute(strip_d, axis, [(i, i - 1) for i in range(1, n)])
            nb_c = jnp.where(lax.axis_index(axis) == n - 1, jnp.inf, nb_c)
            cand_c = jnp.concatenate(
                [jnp.full((h, ws - (D - 1)), jnp.inf, jnp.float32), nb_c], axis=1
            )
            cand_d = jnp.concatenate(
                [jnp.zeros((h, ws - (D - 1)), jnp.int32), nb_d], axis=1
            )
            take_nb = cand_c < own_c
            own_c = jnp.where(take_nb, cand_c, own_c)
            own_d = jnp.where(take_nb, cand_d, own_d)

        # Gather the small winner planes; x-global post-processing runs
        # replicated, then each shard emits its own slice.
        fields = [
            outs["bestd"], outs["bestc"], outs["cm"], outs["cp"], own_d,
        ]
        names = ["bestd", "bestc", "cm", "cp", "rbestd"]
        if cfg.uniqueness_ratio > 0:
            fields.append(outs["ubest"])
            names.append("ubest")
        full = [
            jnp.moveaxis(lax.all_gather(f, axis), 0, 1).reshape(h, n * ws)
            for f in fields
        ]
        gouts = {k: v[:, :w] for k, v in zip(names, full)}
        disp = pipeline.disp_pre_from_winners(gouts, cfg)
        if cfg.median_filter:
            guide = None
            if cfg.median_mode == "weighted":
                lab_full = jnp.stack(
                    [
                        jnp.moveaxis(
                            lax.all_gather(l_blk[4 + c], axis), 0, 1
                        ).reshape(h, n * ws)[:, :w]
                        for c in range(3)
                    ],
                    axis=-1,
                )
                guide = lab_full
            disp = postprocess.median_filter(disp, cfg, guide)
        disp = jnp.pad(disp, ((0, 0), (0, pad)), mode="edge")
        return lax.dynamic_slice(disp, (0, x0), (h, ws))

    out = run(ls, rs)
    return out[:, :w]
