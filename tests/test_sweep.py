"""End-to-end tests for the production batch driver (tools/sweep.py):
threaded submitter, uint16 fetch path, manifest resume."""

import json
import os
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import sweep as sweep_mod  # noqa: E402

# These tests run the sweep on the CPU backend inside the pytest process;
# contending for the card's advisory lock would serialize them behind (or
# time them out against) any concurrent device tool — use a private lock
# file instead.
os.environ.setdefault(
    "ASW_DEVICE_LOCK",
    os.path.join(tempfile.gettempdir(), "asw_sweep_test.lock"),
)


def _run(dir_, extra=()):
    rc = sweep_mod.main([
        "--dir", dir_, "--preset", "middlebury_asw_full",
        "--max-disparity", "8", "--window-radius", "2",
        *extra,
    ])
    assert rc in (0, None)


@pytest.mark.slow
def test_sweep_end_to_end_and_resume(tmp_path):
    d = str(tmp_path)
    sweep_mod.make_synthetic_dataset(d, 4, 48, 64, 8)
    _run(d, ("--make-synthetic", "0"))

    mpath = os.path.join(d, "sweep_manifest.json")
    with open(mpath) as f:
        man = json.load(f)
    assert len(man["done"]) == 4
    for pid, rec in man["done"].items():
        assert os.path.exists(os.path.join(d, f"{pid}_disp.pfm"))
        assert rec["bad_2"] < 0.05, (pid, rec)

    # simulate a crash that lost the last two pairs' records
    for pid in list(man["done"])[2:]:
        del man["done"][pid]
        os.remove(os.path.join(d, f"{pid}_disp.pfm"))
    with open(mpath, "w") as f:
        json.dump(man, f)

    _run(d)
    with open(mpath) as f:
        man2 = json.load(f)
    assert len(man2["done"]) == 4
    for pid in man2["done"]:
        assert os.path.exists(os.path.join(d, f"{pid}_disp.pfm"))


@pytest.mark.slow
def test_sweep_u16_fetch_matches_f32(tmp_path):
    """--fetch u16 (the default, KITTI x256 fixed point) must agree with
    --fetch f32 to the 1/512 px quantization bound on the written maps."""
    from aswstereomatch_tpu.utils import io

    d16, d32 = str(tmp_path / "u16"), str(tmp_path / "f32")
    for d, fetch in ((d16, "u16"), (d32, "f32")):
        sweep_mod.make_synthetic_dataset(d, 2, 48, 64, 8)
        _run(d, ("--fetch", fetch))
    for i in range(2):
        a = io.read_pfm(os.path.join(d16, f"pair{i:04d}_disp.pfm"))
        b = io.read_pfm(os.path.join(d32, f"pair{i:04d}_disp.pfm"))
        valid = b >= 0
        assert np.max(np.abs(a - b)[valid]) <= 1 / 512 + 1e-6
