"""Side-by-side accuracy comparison vs OpenCV StereoBM / StereoSGBM.

The reference's evaluation layer (SURVEY.md section 1, L6) compares its maps
against OpenCV's block matchers; this harness reproduces that comparison on
synthetic layered scenes with exact ground truth: our box and ASW pipelines
vs cv2.StereoBM and cv2.StereoSGBM, bad-delta over non-occluded pixels.

Usage: python tools/compare_opencv.py [--geom tsukuba venus kitti]
                                      [--out bench_results/opencv_compare.json]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(geoms, out_path, regime="smooth"):
    import cv2
    import jax
    import jax.numpy as jnp

    from aswstereomatch_tpu.config import StereoConfig
    from aswstereomatch_tpu.models import pipeline
    from aswstereomatch_tpu.utils import evaluate, synthetic

    rows = []
    for name in geoms:
        h, w, D = synthetic.GEOMETRIES[name]
        if regime == "hard":
            # Adversarial scenes (sensor noise, textureless patches,
            # brightness/contrast mismatch between views) — the regime
            # where robust aggregation separates methods.
            pair = synthetic.make_hard_pair(h, w, D, seed=7)
        else:
            # make_dataset_pair applies the per-scene seed offset, so
            # same-shape scenes (teddy vs cones) get DIFFERENT content.
            pair = synthetic.make_dataset_pair(name, seed=7)
        left, right, gt = pair["left"], pair["right"], pair["gt"]
        nonocc = ~pair["occluded"]
        gl = cv2.cvtColor(left.astype(np.uint8), cv2.COLOR_RGB2GRAY)
        gr = cv2.cvtColor(right.astype(np.uint8), cv2.COLOR_RGB2GRAY)

        def score(tag, disp, valid_extra=None):
            valid = nonocc if valid_extra is None else (nonocc & valid_extra)
            rep = evaluate.bad_report(disp, gt, valid=valid)
            # coverage: fraction of nonocc pixels this method is scored
            # on — cv2 methods invalidate low-confidence pixels, so their
            # error rates are over a confident SUBSET (density inside the
            # mask is 1.0 by construction); ours are dense.
            rows.append(
                dict(geometry=name, method=tag, regime=regime,
                     coverage=round(float(valid.sum() / nonocc.sum()), 4),
                     **{k: round(v, 5) for k, v in rep.items()})
            )

        # ours: box and full ASW
        for tag, cfg in [
            ("ours_ad_box", StereoConfig(
                max_disparity=D, cost="ad", aggregation="box", window_radius=4,
                lr_check=False, fill_holes=False, subpixel=False,
                median_filter=False)),
            ("ours_asw_full", StereoConfig(
                max_disparity=D, cost="tad_grad", aggregation="asw",
                window_radius=16, lr_check=True, fill_holes=True,
                subpixel=True, median_filter=True)),
            ("ours_asw_separable", StereoConfig(
                max_disparity=D, cost="tad_grad", aggregation="asw",
                window_radius=16, asw_separable=True, lr_check=True,
                fill_holes=True, subpixel=True, median_filter=True)),
            # Refuse mode: LR-invalidated pixels stay holes (-1) — the
            # BM/SGBM-style partial-coverage operating point; scored only
            # on kept pixels, like the cv2 rows.
            ("ours_asw_refuse", StereoConfig(
                max_disparity=D, cost="tad_grad", aggregation="asw",
                window_radius=16, lr_check=True, fill_holes=False,
                subpixel=True, median_filter=False)),
            # Semi-global mode (round 5, beyond-reference): the accuracy
            # mode for ambiguous content — dense, like our other rows.
            ("ours_sgm", StereoConfig(
                max_disparity=D, cost="tad_grad", aggregation="sgm",
                lr_check=True, fill_holes=True, subpixel=True,
                median_filter=True)),
        ]:
            fn = jax.jit(functools.partial(pipeline.match_pair, cfg=cfg))
            disp = np.asarray(fn(jnp.asarray(left), jnp.asarray(right)))
            score(tag, disp, (disp >= 0) if tag == "ours_asw_refuse" else None)
            if tag == "ours_asw_full":
                disp_full = disp

        # OpenCV baselines (evaluated where they return valid values)
        bm = cv2.StereoBM_create(numDisparities=D, blockSize=9)
        d_bm = bm.compute(gl, gr).astype(np.float32) / 16.0
        score("cv2_StereoBM", d_bm, d_bm >= 0)

        sgbm = cv2.StereoSGBM_create(
            minDisparity=0, numDisparities=D, blockSize=5,
            P1=8 * 3 * 25, P2=32 * 3 * 25, mode=cv2.STEREO_SGBM_MODE_SGBM,
        )
        d_sg = sgbm.compute(
            left.astype(np.uint8), right.astype(np.uint8)
        ).astype(np.float32) / 16.0
        score("cv2_StereoSGBM", d_sg, d_sg >= 0)

        # Apples-to-apples: OUR dense map scored on exactly the pixels each
        # cv2 method kept — removes the coverage asymmetry (cv2 methods
        # invalidate the hardest pixels; our pipeline fills them).
        score("ours_asw_full@BM_mask", disp_full, d_bm >= 0)
        score("ours_asw_full@SGBM_mask", disp_full, d_sg >= 0)

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rows, f, indent=2)

    # markdown table to stdout
    keys = ["coverage", "bad_0.5", "bad_1", "bad_2", "bad_4", "epe"]
    print("| geometry | method | " + " | ".join(keys) + " |")
    print("|" + "---|" * (2 + len(keys)))
    for r_ in rows:
        print(
            f"| {r_['geometry']} | {r_['method']} | "
            + " | ".join(f"{r_[k]:.4f}" for k in keys)
            + " |"
        )
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--geom", nargs="+", default=["tsukuba", "venus"])
    ap.add_argument("--out", default="bench_results/opencv_compare.json")
    ap.add_argument("--regime", choices=["smooth", "hard"], default="smooth")
    args = ap.parse_args()
    run(args.geom, args.out, regime=args.regime)


if __name__ == "__main__":
    from aswstereomatch_tpu.utils import compile_cache, devlock

    compile_cache.enable()
    with devlock.device_lock("compare_opencv", timeout_s=120):
        main()
