"""Sharded-layout validation at FLAGSHIP geometry.

The multi-device correctness story rests on the tiled==untiled
bit-exactness invariant (SURVEY.md section 4.3).  This tool exercises it at
the production geometry's boundaries, not only at toy shapes:

  - x-tiling at KITTI width over 4 shards: non-divisible 311/310-wide
    shards against the r + D - 1 = 143 right-image halo;
  - y-tiling at tile=2, H=36 puts 18 rows/shard against the halo bound
    r + 1 = 17 — one row of slack;
  - d-sharding: 16 disparities/shard over 8 shards at D=128.

It runs every sharded layout (y-tile ring halo, x-tile with the D_max
right-strip halo, d-shard lexicographic combine) for exact and separable
ASW at width 1242, D=128, r=16 on the 8-device virtual CPU mesh, asserting
each output is bit-for-bit equal to the unsharded pipeline — heights are
reduced (36 rows) because the tight bounds are width/D-dependent.

Run:  python tools/flagship_sharded_check.py          (writes
      bench_results/sharded_flagship.json)
Test: tests/test_sharding_flagship.py calls run_checks() and asserts
      every row's ``exact`` flag.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WIDTH = 1242
D_MAX = 128
RADIUS = 16


def _base_cfg():
    from aswstereomatch_tpu.config import StereoConfig

    return StereoConfig(
        max_disparity=D_MAX, cost="tad_grad", aggregation="asw",
        window_radius=RADIUS, lr_check=True, fill_holes=True,
        subpixel=True, median_filter=True,
    )


def run_checks(progress=print) -> dict:
    """Every sharded layout at flagship geometry vs the unsharded pipeline.

    Returns a record dict; each row carries the layout, the exact shapes
    involved, the boundary it pins, and a bool ``exact``.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from aswstereomatch_tpu.models import pipeline
    from aswstereomatch_tpu.parallel import dshard
    from aswstereomatch_tpu.parallel import mesh as mesh_lib
    from aswstereomatch_tpu.parallel import tiling
    from aswstereomatch_tpu.utils import synthetic

    def J(fn, **static):
        return jax.jit(functools.partial(fn, **static))

    rows = []

    def check(name, out, ref, boundary, shape, mesh_desc):
        ok = bool(np.array_equal(out, ref))
        rows.append({
            "layout": name, "mesh": mesh_desc, "shape": list(shape),
            "max_disparity": D_MAX, "window_radius": RADIUS,
            "boundary": boundary, "exact": ok,
        })
        progress(f"  {name:34s} {mesh_desc:12s} exact={ok}")
        return ok

    for mode in ("exact_asw", "separable_asw"):
        cfg = _base_cfg()
        if mode == "separable_asw":
            cfg = cfg.replace(asw_separable=True)
        h = 36  # y-tile at tile=2: 18 rows/shard vs halo r+1=17
        pair = synthetic.make_pair(
            height=h, width=WIDTH, max_disparity=D_MAX, seed=9
        )
        left, right = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
        t0 = time.perf_counter()
        ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(left, right))
        progress(f"{mode}: untiled ref ({h}x{WIDTH}) in "
                 f"{time.perf_counter() - t0:.0f}s")
        check(
            f"{mode}/y_tile", np.asarray(
                J(tiling.match_pair_tiled, cfg=cfg,
                  device_mesh=mesh_lib.build_mesh(data=1, tile=2))(left, right)
            ), ref,
            "18 rows/shard vs halo r+1=17 (1 row slack)",
            (h, WIDTH), "tile=2 (y)",
        )
        check(
            f"{mode}/x_tile", np.asarray(
                J(tiling.match_pair_tiled_x, cfg=cfg,
                  device_mesh=mesh_lib.build_mesh(data=1, tile=4))(left, right)
            ), ref,
            "shard width 311/310 (non-divisible 1242/4), right halo "
            "r+D-1=143; production kitti mesh_tile=4 layout",
            (h, WIDTH), "tile=4 (x)",
        )
        check(
            f"{mode}/d_shard", np.asarray(
                J(dshard.match_pair_dsharded, cfg=cfg,
                  device_mesh=mesh_lib.build_mesh(data=1, tile=8))(left, right)
            ), ref,
            "16 disparities/shard over 8 shards, lexicographic "
            "(cost, lower-d) combine at D=128",
            (h, WIDTH), "tile=8 (d)",
        )

    import jax

    return {
        "what": "sharded layouts vs unsharded pipeline, bit-exact, at "
                "flagship geometry (width 1242, D=128, r=16; reduced "
                "heights — bounds are width/D-dependent)",
        "devices": jax.device_count(),
        "platform": jax.default_backend(),
        "all_exact": all(r["exact"] for r in rows),
        "rows": rows,
    }


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    rec = run_checks()
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench_results",
        "sharded_flagship.json")
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({"all_exact": rec["all_exact"], "rows": len(rec["rows"]),
                      "record": out}))
    return 0 if rec["all_exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
