"""Coverage-vs-accuracy operating curves vs cv2 BM/SGBM (hard regime).

Refuse-mode as a tunable operating curve rather
than a single ``fill_holes=False`` point.  The per-pixel confidence is the
WTA-uniqueness margin (``pipeline.match_pair_with_confidence``) — the knob
cv2.StereoBM/SGBM ship as ``uniquenessRatio`` — composed with the LR
check.  One device run per (geometry, mode) fetches disp + confidence;
every operating point is then a host-side threshold (no recompiles).

Measured against cv2 BM and SGBM swept over THEIR uniquenessRatio, on the
hard adversarial regime (sensor noise, textureless patches, brightness
mismatch).  For each cv2 operating point the table also scores our dense
map on exactly the cv2-kept pixels (exact matched coverage) and quotes
our curve point with the nearest coverage.

Run: python tools/refuse_curve.py [--geom kitti venus] [--seeds 7 8]
     (writes bench_results/refuse_curve.json)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUR_RATIOS = (0.0, 2.0, 5.0, 8.0, 12.0, 18.0, 25.0, 40.0)
CV2_RATIOS = (5, 10, 15)


def run(geoms, seeds, out_path):
    import cv2
    import jax.numpy as jnp

    from aswstereomatch_tpu.config import StereoConfig
    from aswstereomatch_tpu.models.pipeline import StereoMatcher
    from aswstereomatch_tpu.utils import evaluate, synthetic

    rows = []

    def add(geometry, seed, method, point, disp, keep, gt, nonocc):
        scored = nonocc & keep
        rep = evaluate.bad_report(disp, gt, valid=scored)
        rows.append(dict(
            geometry=geometry, seed=seed, method=method, point=point,
            coverage=round(float(scored.sum() / nonocc.sum()), 4),
            bad_2=round(rep["bad_2"], 5), epe=round(rep["epe"], 4),
        ))
        return rows[-1]

    for name in geoms:
        h, w, D = synthetic.GEOMETRIES[name]
        for seed in seeds:
            pair = synthetic.make_hard_pair(h, w, D, seed=seed)
            left, right, gt = pair["left"], pair["right"], pair["gt"]
            nonocc = ~pair["occluded"]
            l_dev, r_dev = jnp.asarray(left), jnp.asarray(right)

            for mode, agg, sep in (("exact", "asw", False),
                                   ("sep", "asw", True),
                                   ("sgm", "sgm", False)):
                cfg = StereoConfig(
                    max_disparity=D, cost="tad_grad", aggregation=agg,
                    window_radius=16, asw_separable=sep, lr_check=True,
                    fill_holes=False, subpixel=True, median_filter=False,
                )

                disp, uniq, lrv = StereoMatcher(cfg).with_confidence(
                    l_dev, r_dev
                )
                disp = np.asarray(disp)
                uniq = np.asarray(uniq)
                lrv = np.asarray(lrv)
                # our tunable curve: LR gate AND uniqueness threshold
                for rr in OUR_RATIOS:
                    add(name, seed, f"ours_{mode}_refuse", f"uniq>={rr:g}",
                        disp, (disp >= 0) & (uniq >= rr), gt, nonocc)
                # dense map for the exact-matched-coverage rows
                cfg_dense = cfg.replace(fill_holes=True, median_filter=True)
                dense = np.asarray(StereoMatcher(cfg_dense)(l_dev, r_dev))
                if mode == "exact":
                    dense_exact = dense
                add(name, seed, f"ours_{mode}_dense", "fill_all",
                    dense, np.ones_like(nonocc), gt, nonocc)

            gl = cv2.cvtColor(left.astype(np.uint8), cv2.COLOR_RGB2GRAY)
            gr = cv2.cvtColor(right.astype(np.uint8), cv2.COLOR_RGB2GRAY)
            for ur in CV2_RATIOS:
                bm = cv2.StereoBM_create(numDisparities=D, blockSize=9)
                bm.setUniquenessRatio(ur)
                d_bm = bm.compute(gl, gr).astype(np.float32) / 16.0
                add(name, seed, "cv2_BM", f"uniq={ur}", d_bm, d_bm >= 0,
                    gt, nonocc)
                add(name, seed, "ours_exact_dense@BM_mask", f"uniq={ur}",
                    dense_exact, d_bm >= 0, gt, nonocc)
                sgbm = cv2.StereoSGBM_create(
                    minDisparity=0, numDisparities=D, blockSize=5,
                    P1=8 * 3 * 25, P2=32 * 3 * 25,
                    uniquenessRatio=ur, mode=cv2.STEREO_SGBM_MODE_SGBM,
                )
                d_sg = sgbm.compute(
                    left.astype(np.uint8), right.astype(np.uint8)
                ).astype(np.float32) / 16.0
                add(name, seed, "cv2_SGBM", f"uniq={ur}", d_sg, d_sg >= 0,
                    gt, nonocc)
                add(name, seed, "ours_exact_dense@SGBM_mask", f"uniq={ur}",
                    dense_exact, d_sg >= 0, gt, nonocc)

    # nearest-coverage pairing: for every cv2 point, our curve point with
    # the closest coverage (same geometry/seed/weight-mode=exact)
    matched = []
    ours = [r for r in rows if r["method"] == "ours_exact_refuse"]
    for r in rows:
        if r["method"] not in ("cv2_BM", "cv2_SGBM"):
            continue
        cands = [o for o in ours
                 if o["geometry"] == r["geometry"] and o["seed"] == r["seed"]]
        if not cands:
            continue
        near = min(cands, key=lambda o: abs(o["coverage"] - r["coverage"]))
        matched.append(dict(
            geometry=r["geometry"], seed=r["seed"],
            cv2=f"{r['method']}@{r['point']}",
            cv2_coverage=r["coverage"], cv2_bad_2=r["bad_2"],
            ours=near["point"], ours_coverage=near["coverage"],
            ours_bad_2=near["bad_2"],
            ours_wins=near["bad_2"] <= r["bad_2"],
        ))

    rec = {
        "what": "coverage-vs-bad-2.0 operating curves on the hard regime: "
                "our LR+uniqueness confidence (thresholded host-side from "
                "one device run) vs cv2 BM/SGBM swept over uniquenessRatio",
        "rows": rows,
        "matched_coverage": matched,
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)

    print("| geometry | seed | method | point | coverage | bad_2 | epe |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['geometry']} | {r['seed']} | {r['method']} | "
              f"{r['point']} | {r['coverage']:.3f} | {r['bad_2']:.4f} | "
              f"{r['epe']:.3f} |")
    wins = sum(m["ours_wins"] for m in matched)
    print(json.dumps({"matched_points": len(matched),
                      "ours_wins_or_ties": wins, "record": out_path}))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--geom", nargs="+", default=["kitti", "venus"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[7, 8])
    ap.add_argument("--out", default="bench_results/refuse_curve.json")
    args = ap.parse_args()
    run(args.geom, args.seeds, args.out)


if __name__ == "__main__":
    from aswstereomatch_tpu.utils import compile_cache, devlock

    compile_cache.enable()
    with devlock.device_lock("refuse_curve", timeout_s=300):
        main()
