"""Postprocess stage-cost ladder on the GPU.

The postprocess — LR check + hole fill, subpixel, median — runs as an
epilogue inside the same jit program as aggregation and WTA (SURVEY.md §3.1
L5).  This tool attributes wall time to each stage by timing a cumulative
config ladder:

    wta_only -> +subpixel -> +lr/fill -> +median  (= the preset default)

Each rung is one program (persistent-compile-cached, so re-runs are warm);
the deltas between rungs are the stage costs.  Refuses to run without a
GPU; the summary names the card and its power limit.

Usage: python tools/profile_stages.py [--geometry kitti] [--left-only]
       [--box] [--separable]
Emits one JSON line per rung plus a summary attribution.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


GEOMS = {
    "kitti": dict(height=375, width=1242, max_disparity=128),
    "middlebury": dict(height=375, width=450, max_disparity=64),
    "tsukuba": dict(height=288, width=384, max_disparity=16),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--geometry", default="kitti", choices=sorted(GEOMS))
    ap.add_argument("--left-only", action="store_true")
    ap.add_argument("--box", action="store_true")
    ap.add_argument("--separable", action="store_true")
    ap.add_argument("--queue", type=int, default=8)
    args = ap.parse_args()
    if args.box and args.separable:
        ap.error("--separable applies to ASW only; with --box the pipeline "
                 "would silently fall to the jnp path and the stage "
                 "attribution would be mislabeled")

    import jax
    import jax.numpy as jnp

    from aswstereomatch_tpu.config import StereoConfig
    from aswstereomatch_tpu.models.pipeline import StereoMatcher
    from aswstereomatch_tpu.utils import (
        compile_cache, devlock, device, synthetic,
    )

    compile_cache.enable()
    device.require_gpu()
    card = device.card_line()
    with devlock.device_lock("profile_stages", timeout_s=120):
        return _run(args, jax, jnp, StereoConfig, StereoMatcher, synthetic,
                    card)


def _run(args, jax, jnp, StereoConfig, StereoMatcher, synthetic, card):
    g = dict(GEOMS[args.geometry])
    r_win = g.pop("window_radius", 16)
    pair = synthetic.make_pair(seed=0, **g)
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])

    base = dict(
        max_disparity=g["max_disparity"], cost="tad_grad",
        aggregation="box" if args.box else "asw",
        window_radius=r_win,
        asw_symmetric=not args.left_only,
        asw_separable=args.separable,
    )
    ladder = [
        ("wta_only", dict(lr_check=False, fill_holes=False, subpixel=False,
                          median_filter=False)),
        ("+subpixel", dict(lr_check=False, fill_holes=False, subpixel=True,
                           median_filter=False)),
        ("+lr_fill", dict(lr_check=True, fill_holes=True, subpixel=True,
                          median_filter=False)),
        ("+median", dict(lr_check=True, fill_holes=True, subpixel=True,
                         median_filter=True)),
        ("+wmedian", dict(lr_check=True, fill_holes=True, subpixel=True,
                          median_filter=True, median_mode="weighted")),
    ]

    rows = []
    for name, over in ladder:
        cfg = StereoConfig(**base, **over)
        fn = StereoMatcher(cfg)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(l, r))
        compile_s = time.perf_counter() - t0
        jax.block_until_ready(fn(l, r))
        Q = args.queue
        t0 = time.perf_counter()
        jax.block_until_ready([fn(l, r) for _ in range(Q)])
        queued_s = (time.perf_counter() - t0) / Q
        row = {
            "rung": name,
            "s_per_pair": round(queued_s, 5),
            "delta_ms": round(
                1e3 * (queued_s - rows[-1]["s_per_pair"]), 2
            ) if rows else 0.0,
            "compile_s": round(compile_s, 1),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    full = rows[-2]  # "+median" (plain) is the preset default
    print(json.dumps({
        "geometry": args.geometry,
        "mode": ("box" if args.box else
                 "left_only" if args.left_only else "symmetric")
        + ("+separable" if args.separable else ""),
        "epilogue_share_pct": round(
            100 * (full["s_per_pair"] - rows[0]["s_per_pair"])
            / full["s_per_pair"], 2),
        "pairs_per_s_full": round(1 / full["s_per_pair"], 3),
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
