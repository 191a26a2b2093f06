"""Sharded layouts at FLAGSHIP geometry (width 1242, D=128, r=16).

The tiled==untiled bit-exactness invariant (SURVEY.md section 4.3) must be
proven at the geometry whose bounds are actually tight — the production
kitti mesh_tile=4 non-divisible shard widths against the r + D - 1 right
halo, 18 rows/shard against the r + 1 y-halo — not just the toy shapes in
test_sharding.py.  Heights are reduced (36 rows): every tight bound is
width/D-dependent.

The check logic lives in tools/flagship_sharded_check.py (which also
writes the committed record bench_results/sharded_flagship.json); this
test drives the same code and asserts every row.  ~8 min on 4 CPU cores —
the exact O(K^2) window at KITTI width is ~1.3e11 window-ops per match.
"""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))


@pytest.mark.slow
def test_flagship_sharded_layouts_bit_exact():
    import flagship_sharded_check as fsc

    rec = fsc.run_checks(progress=lambda *_: None)
    failed = [r for r in rec["rows"] if not r["exact"]]
    assert rec["rows"], "no layouts ran"
    assert not failed, failed
    # every layout family must be present: y, x, d, for exact and separable
    names = {r["layout"] for r in rec["rows"]}
    for want in ("exact_asw/y_tile", "exact_asw/x_tile", "exact_asw/d_shard",
                 "separable_asw/y_tile", "separable_asw/x_tile",
                 "separable_asw/d_shard"):
        assert want in names, want
