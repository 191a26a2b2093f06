"""Disparity-axis sharding — the tensor-parallel analog (SURVEY.md 2.2).

Shards the candidate-disparity axis over the mesh "tile" axis: each device
aggregates only its D/n-candidate slab (cost + ASW for those d's — the slab
never exceeds D/n planes, so large volumes fit),
runs a local WTA with the subpixel triple, and the global winner is a
lexicographic (cost, then lower-d) min-combine across shards — the collective
equivalent of a (cost, index)-pair pmin.  The right-view partial argmin is
combined the same way.

First-occurrence argmin is preserved exactly: shard k owns disparities
[k*Ds, (k+1)*Ds), so an ordered strict-< merge over ascending shards
reproduces the untiled tie-break (tests pin dsharded == unsharded on the
integer WTA and LR outputs; aggregated values are reduction-order-identical
since each d is computed wholly on one shard).

Slabs carry one overlap disparity per side so the winner's parabola triple
(C[d*-1], C[d*+1]) is available locally even at slab boundaries.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import StereoConfig
from ..models import pipeline
from ..ops import aggregate, postprocess
from . import mesh as mesh_lib


def match_pair_dsharded(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: StereoConfig,
    device_mesh: Mesh,
) -> jnp.ndarray:
    """Single pair with the disparity axis sharded over "tile".

    Images are replicated (they are ~100x smaller than the volume); only
    per-shard winner planes cross the interconnect in the combine step.
    ASW only: d-sharded box aggregation is not supported.
    """
    axis = mesh_lib.TILE_AXIS
    n = device_mesh.shape[axis]
    D = cfg.max_disparity
    if D % n:
        raise ValueError(f"max_disparity {D} not divisible by {n} d-shards")
    if cfg.uniqueness_ratio > 0:
        # Each shard sees only its d-slab, so the second-best-excluding-
        # best+-1 operand would be per-slab, not global — combining it
        # exactly needs cross-shard knowledge of the global winner.  The
        # y/x-tiled layouts keep full d rows per pixel and support the
        # gate; reject here instead of silently computing a different
        # statistic.
        raise ValueError(
            "uniqueness_ratio is not supported with disparity sharding "
            "(per-shard slabs cannot form the global second-best cost); "
            "use tile_axis 'y'/'x' or an unsharded run"
        )
    ds = D // n
    h, w = left.shape[:2]

    if cfg.aggregation != "asw":
        raise ValueError(
            "disparity sharding covers the asw aggregation only"
        )

    @functools.partial(
        shard_map,
        mesh=device_mesh,
        in_specs=(P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(l_img, r_img):
        k = lax.axis_index(axis)
        d0 = k * ds
        take = lambda a, i: jnp.take_along_axis(a, i[..., None], axis=-1)[..., 0]
        # Slab with one overlap d per side (clamped) for the triple.
        local = jnp.arange(ds + 2) - 1
        d_idx = jnp.clip(d0 + local, 0, D - 1)
        slab = aggregate.aggregate_asw(l_img, r_img, cfg, d_indices=d_idx)
        interior = slab[..., 1 : 1 + ds]  # (H, W, ds)

        # Local left-view winner + triple.
        loc = jnp.argmin(interior, axis=-1).astype(jnp.int32)
        bestc = take(interior, loc)
        cm = take(slab, loc)          # slab index loc = interior loc - 1
        cp = take(slab, loc + 2)
        bestd = d0 + loc

        # Local right-view partial: C_R(x', d) = C_L(x'+d, d), d in slab.
        x = jnp.arange(w)[None, :, None]
        dg = (d0 + jnp.arange(ds))[None, None, :]
        idx = x + dg  # (1, W, ds)
        gathered = jnp.take_along_axis(
            interior,
            jnp.broadcast_to(jnp.minimum(idx, w - 1), interior.shape),
            axis=1,
        )
        rslab = jnp.where(idx <= w - 1, gathered, jnp.inf)
        rloc = jnp.argmin(rslab, axis=-1).astype(jnp.int32)
        rbestc = take(rslab, rloc)
        rbestd = d0 + rloc

        # Global combine: ordered strict-< merge over ascending shards.
        parts = lax.all_gather(
            (bestc, bestd, cm, cp, rbestc, rbestd), axis
        )  # each (n, H, W)

        def merge(carry, i):
            bc, bd, bcm, bcp, rc, rd = carry
            c_i = parts[0][i]
            win = c_i < bc
            carry = (
                jnp.where(win, c_i, bc),
                jnp.where(win, parts[1][i], bd),
                jnp.where(win, parts[2][i], bcm),
                jnp.where(win, parts[3][i], bcp),
                rc, rd,
            )
            rwin = parts[4][i] < rc
            carry = carry[:4] + (
                jnp.where(rwin, parts[4][i], rc),
                jnp.where(rwin, parts[5][i], rd),
            )
            return carry, None
        init = tuple(p[0] for p in parts)
        (bc, bd, bcm, bcp, rc, rd), _ = lax.scan(
            merge, init, jnp.arange(1, n)
        )

        outs = {"bestc": bc, "bestd": bd, "cm": bcm, "cp": bcp, "rbestd": rd}
        disp = pipeline.disp_pre_from_winners(outs, cfg)
        if cfg.median_filter:
            disp = postprocess.median_filter(
                disp, cfg, pipeline._guide_lab(l_img, cfg)
            )
        return disp.astype(jnp.float32)

    return run(left, right)
