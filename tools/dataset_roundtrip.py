"""Materialize synthetic scenes in the REAL dataset on-disk formats and
drive the file-based CLI over them — the dataset workflow proven end to
end (SURVEY.md section 2.1 "Datasets" row; real Middlebury/KITTI files
remain unavailable in this environment: no network, none on disk).

Per scene the pair is written exactly as the datasets ship it, via the
zero-dependency native PNG codec (native/stereoio.cpp):

  tsukuba      8-bit RGB PNG pair; GT 8-bit PNG, disparity x16 (Middlebury 2001)
  venus        same, x8 — generated with D=32 so the x8 encoding fits 8 bits,
               as the real scene's disparities do
  teddy/cones  same, x4 (Middlebury 2003)
  kitti        GT uint16 PNG, disparity x256, 0 = invalid (occlusions
               encoded invalid, KITTI convention)

Then ``cli.py --left/--right/--gt --dataset <scene>`` runs the matcher on
the DECODED files (imread -> match -> imwrite -> evaluate — the
reference's whole L0..L7 file workflow), and the tool asserts GT decode
fidelity (synthetic integer disparities make the scale round trip exact).
Writes bench_results/dataset_roundtrip.json.

Usage: python tools/dataset_roundtrip.py [--dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# scene -> (H, W, D, GT scale, GT bit depth, extra cli args)
SCENES = {
    "tsukuba": (288, 384, 16, 16.0, 8, ["--max-disparity", "16"]),
    # real venus disparities are < 32, which is why x8 fits 8 bits
    "venus": (375, 450, 32, 8.0, 8, ["--max-disparity", "32"]),
    "teddy": (375, 450, 64, 4.0, 8, []),
    "cones": (375, 450, 64, 4.0, 8, []),
    "kitti": (375, 1242, 128, 256.0, 16, ["--max-disparity", "128"]),
}


def write_scene(dir_: str, scene: str, seed: int):
    from aswstereomatch_tpu.utils import io, native, synthetic

    h, w, d, scale, bits, _ = SCENES[scene]
    pair = synthetic.make_pair(height=h, width=w, max_disparity=d, seed=seed)
    sdir = os.path.join(dir_, scene)
    os.makedirs(sdir, exist_ok=True)
    paths = {k: os.path.join(sdir, f"{k}.png") for k in ("im0", "im1", "disp0")}
    native.write_png(paths["im0"], np.round(pair["left"]))
    native.write_png(paths["im1"], np.round(pair["right"]))
    enc = np.round(pair["gt"] * scale)
    if scene == "kitti":
        enc = np.where(pair["occluded"], 0.0, enc)  # 0 = invalid
    limit = 255 if bits == 8 else 65535
    assert enc.max() <= limit, (scene, enc.max())
    native.write_png(paths["disp0"], enc, bit_depth=bits)

    # decode fidelity: the scale convention must round-trip exactly
    # (synthetic layer disparities are integers)
    dec, valid = io.read_gt_disparity(paths["disp0"], scene)
    ref = np.where(pair["occluded"], 0.0, pair["gt"]) if scene == "kitti" \
        else pair["gt"]
    err = float(np.abs(dec[valid] - ref[valid]).max()) if valid.any() else 0.0
    assert err == 0.0, (scene, err)
    # quantize the in-memory pair the way the files store it, for reference
    return paths, pair


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "asw_datasets"))
    ap.add_argument("--out", default="bench_results/dataset_roundtrip.json")
    args = ap.parse_args()

    rows = []
    for i, scene in enumerate(SCENES):
        paths, _pair = write_scene(args.dir, scene, seed=40 + i)
        _, _, d, scale, bits, extra = SCENES[scene]
        preset = "kitti_sep" if scene == "kitti" else "middlebury_asw_full"
        rec_path = os.path.join(args.dir, scene, "record.json")
        cmd = [
            sys.executable, os.path.join(REPO, "cli.py"),
            "--left", paths["im0"], "--right", paths["im1"],
            "--gt", paths["disp0"], "--dataset", scene,
            "--preset", preset, *extra,
            "--json", rec_path,
            "--out", os.path.join(args.dir, scene, "disp_ours.png"),
            "--err-out", os.path.join(args.dir, scene, "err.png"),
        ]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout[-2000:], r.stderr[-2000:], file=sys.stderr)
            raise SystemExit(f"cli failed on {scene}")
        with open(rec_path) as f:
            rec = json.load(f)
        rows.append({
            "scene": scene,
            "gt_format": f"PNG {bits}-bit x{scale:g}"
                         + (" (0=invalid)" if scene == "kitti" else ""),
            "preset": preset,
            "valid_note": "nonocc (invalid-coded occlusions)"
                          if scene == "kitti" else
                          "all pixels (Middlebury 8-bit GT has no invalid "
                          "code; synthetic GT is exact everywhere)",
            "metrics": rec.get("metrics"),
            "pairs_per_s": rec.get("pairs_per_s"),
            "config_hash": rec.get("config_hash"),
        })
        print(json.dumps(rows[-1]), flush=True)

    out = os.path.join(REPO, args.out)
    with open(out, "w") as f:
        json.dump({
            "note": "synthetic scenes stored in the real datasets' on-disk "
                    "formats (native PNG codec), matched via the file-based "
                    "CLI end to end; GT scale conventions round-trip "
                    "exactly (asserted)",
            "rows": rows,
        }, f, indent=2)
    print("wrote", out)


if __name__ == "__main__":
    from aswstereomatch_tpu.utils import devlock

    with devlock.device_lock("dataset_roundtrip", timeout_s=300):
        main()
