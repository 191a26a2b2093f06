"""Command-line driver (SURVEY.md section 1, L7 + section 5 observability).

Replacement for the reference's main(): load (or synthesize) a
rectified pair, run a configured matcher, write the disparity map + error-map
artifacts and a structured JSON run record (config hash, bad-delta table,
density, pairs/s, device).

Examples:
  python cli.py --synthetic kitti --preset kitti_tiled --json out.json
  python cli.py --left l.png --right r.png --gt gt.png --dataset kitti \\
      --preset middlebury_asw_full --out disp.png
  python cli.py --synthetic venus --preset middlebury_asw --profile /tmp/trace
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_argument_group("input")
    src.add_argument("--left", help="left image path")
    src.add_argument("--right", help="right image path")
    src.add_argument("--gt", help="ground-truth disparity path")
    src.add_argument("--dataset", default="kitti",
                     help="GT scale convention (tsukuba/venus/teddy/cones/kitti)")
    src.add_argument("--synthetic",
                     help="use a synthetic pair with this dataset geometry "
                          "(tsukuba/venus/teddy/cones/kitti)")
    src.add_argument("--seed", type=int, default=0)
    cfg = ap.add_argument_group("config")
    cfg.add_argument("--preset", help="named preset (see config.PRESETS)")
    cfg.add_argument("--max-disparity", type=int)
    cfg.add_argument("--cost", choices=["ad", "tad_grad"])
    cfg.add_argument("--aggregation", choices=["none", "box", "asw", "sgm"])
    cfg.add_argument("--window-radius", type=int)
    cfg.add_argument("--y-chunks", type=int)
    cfg.add_argument("--left-only-weights", action="store_true",
                     help="left-only ASW weights (an approximation of the "
                          "symmetric two-view weighting; bad-2.0 stays within "
                          "the 1%% budget)")
    cfg.add_argument("--separable", action="store_true",
                     help="two-pass separable ASW approximation (O(K) taps "
                          "per pixel instead of O(K^2); accuracy tracks "
                          "exact ASW on the hard synthetic regime)")
    cfg.add_argument("--uniqueness-ratio", type=float,
                     help="cv2-style WTA-uniqueness confidence gate: reject "
                     "a pixel unless its best cost wins the second-best over "
                     "d outside [best-1, best+1] by this percent (0 = off)")
    cfg.add_argument("--no-fill", action="store_true",
                     help="refuse mode: gated pixels stay -1 instead of "
                     "being filled (partial-coverage operating point)")
    cfg.add_argument("--no-postprocess", action="store_true",
                     help="disable LR check / fill / subpixel / median")
    run = ap.add_argument_group("execution")
    run.add_argument("--mesh", default=None,
                     help="DATAxTILE device mesh, e.g. 1x4 (uses shard_map tiling)")
    run.add_argument("--shard-axis", default="y", choices=["y", "x", "d"],
                     help="what the mesh 'tile' axis shards: image rows (y), "
                          "image columns with the D_max halo (x), or the "
                          "disparity axis (d)")
    run.add_argument("--iters", type=int, default=1, help="timing iterations")
    run.add_argument("--profile", help="write a jax.profiler trace to this dir")
    out = ap.add_argument_group("output")
    out.add_argument("--out", help="disparity visualization PNG/PGM path")
    out.add_argument("--err-out", help="error-map visualization path (needs --gt)")
    out.add_argument("--json", dest="json_out", help="structured run record path")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax
    import jax.numpy as jnp

    from aswstereomatch_tpu import StereoConfig, get_preset
    from aswstereomatch_tpu.parallel import api as parallel_api
    from aswstereomatch_tpu.utils import evaluate, io, profiling, synthetic

    # ---- inputs -------------------------------------------------------------
    gt = valid = None
    if args.synthetic:
        pair = synthetic.make_dataset_pair(args.synthetic, seed=args.seed)
        left, right, gt = pair["left"], pair["right"], pair["gt"]
        valid = ~pair["occluded"]
        geom_d = synthetic.GEOMETRIES[args.synthetic.lower()][2]
    elif args.left and args.right:
        left = io.read_image(args.left)
        right = io.read_image(args.right)
        geom_d = 64
        if args.gt:
            gt, valid = io.read_gt_disparity(args.gt, args.dataset)
    else:
        print("need --left/--right or --synthetic", file=sys.stderr)
        return 2

    # ---- config -------------------------------------------------------------
    cfg = get_preset(args.preset) if args.preset else StereoConfig(
        max_disparity=geom_d
    )
    overrides = {}
    for field, name in [
        ("max_disparity", "max_disparity"), ("cost", "cost"),
        ("aggregation", "aggregation"), ("window_radius", "window_radius"),
        ("y_chunks", "y_chunks"), ("uniqueness_ratio", "uniqueness_ratio"),
    ]:
        v = getattr(args, name)
        if v is not None:
            overrides[field] = v
    if args.no_fill:
        overrides["fill_holes"] = False
    if args.left_only_weights:
        overrides["asw_symmetric"] = False
    if args.separable:
        overrides["asw_separable"] = True
    if args.no_postprocess:
        overrides.update(
            lr_check=False, fill_holes=False, subpixel=False, median_filter=False
        )
    if overrides:
        cfg = cfg.replace(**overrides)

    # ---- run ----------------------------------------------------------------
    l_dev, r_dev = jnp.asarray(left), jnp.asarray(right)
    if args.mesh:
        nd, nt = (int(v) for v in args.mesh.lower().split("x"))
        cfg = cfg.replace(mesh_data=nd, mesh_tile=nt, tile_axis=args.shard_axis)
    t0 = time.perf_counter()
    if not parallel_api.layout_fits(cfg):
        # Single-device (including a declared mesh that doesn't fit the
        # visible devices — layout_fits warns and sharded_match_fn would run
        # the identical unsharded pipeline).
        from aswstereomatch_tpu.models.pipeline import StereoMatcher

        # 8-bit sources (PNG/PNM) ship to the device as uint8 — 4x less
        # host-to-device transfer, lossless (the compiled program widens
        # to f32 on device); non-integral inputs (PFM floats) stay f32.
        # Only this branch: the sharded path's jit expects float input.
        if all(
            float(np.min(a)) >= 0 and float(np.max(a)) <= 255
            and np.array_equal(a, np.floor(a)) for a in (left, right)
        ):
            l_dev = jnp.asarray(left.astype(np.uint8))
            r_dev = jnp.asarray(right.astype(np.uint8))
        fn = StereoMatcher(cfg)
    else:
        fn = jax.jit(parallel_api.sharded_match_fn(cfg))

    disp = jax.block_until_ready(fn(l_dev, r_dev))
    compile_s = time.perf_counter() - t0

    with profiling.trace(args.profile):
        best_s, mean_s, _ = profiling.time_fn(
            fn, l_dev, r_dev, iters=max(args.iters, 1), warmup=1
        )
    disp = np.asarray(disp)

    # ---- record -------------------------------------------------------------
    record = {
        "config": dataclasses.asdict(cfg),
        "config_hash": cfg.config_hash(),
        "device": str(jax.devices()[0]),
        "shape": list(disp.shape),
        "compile_s": round(compile_s, 3),
        "best_s": round(best_s, 5),
        "mean_s": round(mean_s, 5),
        "pairs_per_s": round(1.0 / best_s, 3),
        "density": float(np.isfinite(disp).mean()),
    }
    if gt is not None:
        record["metrics"] = {
            k: round(v, 5)
            for k, v in evaluate.bad_report(disp, gt, valid=valid).items()
        }
    print(json.dumps(record, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(record, f, indent=2)
    if args.out:
        io.save_disparity_png(args.out, disp, cfg.max_disparity)
    if args.err_out and gt is not None:
        err = np.clip(np.abs(disp - gt) / 4.0 * 255.0, 0, 255)
        io.save_disparity_png(args.err_out, err, 256)
    return 0


if __name__ == "__main__":
    from aswstereomatch_tpu.utils import compile_cache

    compile_cache.enable()
    sys.exit(main())
