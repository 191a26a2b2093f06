"""CLI driver smoke tests (in-process, tiny geometry, CPU)."""

import json

import numpy as np

import cli as cli_mod
from aswstereomatch_tpu.utils import io, synthetic


def run_cli(args):
    return cli_mod.main(args)


def test_cli_synthetic_run(tmp_path, capsys):
    out_json = tmp_path / "run.json"
    rc = run_cli([
        "--synthetic", "tsukuba", "--max-disparity", "8",
        "--aggregation", "box", "--window-radius", "2", "--no-postprocess",
        "--json", str(out_json), "--out", str(tmp_path / "disp.pgm"),
        "--err-out", str(tmp_path / "err.pgm"),
    ])
    assert rc == 0
    rec = json.loads(out_json.read_text())
    assert rec["metrics"]["bad_2"] < 0.2
    assert rec["pairs_per_s"] > 0
    assert rec["config_hash"]
    disp = io.read_pnm(str(tmp_path / "disp.pgm"))
    assert disp.shape == tuple(rec["shape"])


def test_cli_separable_run(tmp_path):
    out_json = tmp_path / "sep.json"
    rc = run_cli([
        "--synthetic", "tsukuba", "--max-disparity", "8",
        "--aggregation", "asw", "--window-radius", "2", "--separable",
        "--json", str(out_json),
    ])
    assert rc == 0
    rec = json.loads(out_json.read_text())
    assert rec["metrics"]["bad_2"] < 0.2
    assert rec["config"]["asw_separable"] is True


def test_cli_file_inputs(tmp_path):
    pair = synthetic.make_pair(height=24, width=40, max_disparity=8, seed=1)
    lp, rp = str(tmp_path / "l.ppm"), str(tmp_path / "r.ppm")
    for path, img in [(lp, pair["left"]), (rp, pair["right"])]:
        arr = img.astype(np.uint8)
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
            f.write(arr.tobytes())
    gt = str(tmp_path / "gt.pfm")
    io.write_pfm(gt, pair["gt"] * 256.0)  # kitti convention scale
    rc = run_cli([
        "--left", lp, "--right", rp, "--gt", gt, "--dataset", "kitti",
        "--max-disparity", "8", "--aggregation", "box", "--window-radius", "2",
        "--no-postprocess", "--json", str(tmp_path / "r.json"),
    ])
    assert rc == 0


def test_cli_mesh_run(tmp_path):
    rc = run_cli([
        "--synthetic", "tsukuba", "--max-disparity", "8",
        "--aggregation", "box", "--window-radius", "2", "--no-postprocess",
        "--mesh", "1x4", "--json", str(tmp_path / "m.json"),
    ])
    assert rc == 0


def test_cli_missing_inputs():
    assert run_cli([]) == 2


def test_cli_shard_axes(tmp_path):
    for axis in ("y", "x", "d"):
        rc = run_cli([
            "--synthetic", "tsukuba", "--max-disparity", "8",
            "--aggregation", "asw", "--window-radius", "2", "--no-postprocess",
            "--mesh", "1x4", "--shard-axis", axis,
            "--json", str(tmp_path / f"{axis}.json"),
        ])
        assert rc == 0, axis


def test_cli_dataset_convention_pngs(tmp_path):
    """Both real GT on-disk conventions through the file-based CLI: an
    8-bit Middlebury scaled PNG (tsukuba x16) and a KITTI uint16 x256 PNG
    with 0 = invalid, written by the native codec — the tiny-scale twin of
    tools/dataset_roundtrip.py (which runs the real geometries)."""
    import pytest

    from aswstereomatch_tpu.utils import native

    if not native.available():
        pytest.skip("native codec not built")
    pair = synthetic.make_pair(height=32, width=56, max_disparity=8, seed=2)
    lp, rp = str(tmp_path / "im0.png"), str(tmp_path / "im1.png")
    native.write_png(lp, np.round(pair["left"]))
    native.write_png(rp, np.round(pair["right"]))

    # tsukuba convention: 8-bit x16 (synthetic integer disparities -> exact)
    gt8 = str(tmp_path / "gt_x16.png")
    native.write_png(gt8, np.round(pair["gt"] * 16.0))
    dec, valid = io.read_gt_disparity(gt8, "tsukuba")
    assert valid.all() and np.abs(dec - pair["gt"]).max() == 0.0

    # kitti convention: uint16 x256, occlusions coded 0 = invalid
    gt16 = str(tmp_path / "gt_x256.png")
    native.write_png(
        gt16, np.where(pair["occluded"], 0.0, pair["gt"]) * 256.0,
        bit_depth=16,
    )
    dec, valid = io.read_gt_disparity(gt16, "kitti")
    assert (valid == ~pair["occluded"]).all()
    assert np.abs(dec[valid] - pair["gt"][valid]).max() == 0.0

    for gt, ds in [(gt8, "tsukuba"), (gt16, "kitti")]:
        out_json = tmp_path / f"run_{ds}.json"
        rc = run_cli([
            "--left", lp, "--right", rp, "--gt", gt, "--dataset", ds,
            "--max-disparity", "8", "--aggregation", "asw",
            "--window-radius", "2", "--json", str(out_json),
        ])
        assert rc == 0
        rec = json.loads(out_json.read_text())
        assert rec["metrics"]["bad_2"] < 0.2
