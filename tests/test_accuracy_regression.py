"""Pinned accuracy-regression thresholds on the adversarial synthetic regime.

Round 1's layered scenes were too easy (bad-2.0 <= 0.4% everywhere) to catch
accuracy regressions from performance work (reduced-precision storage,
left-only fast paths, kernel restructurings).  ``synthetic.make_hard_pair`` adds
textureless patches, per-view sensor noise, fractional disparities, and a
brightness/contrast mismatch between views; measured error rates there are
1.6-8.6% bad-2.0 — real signal.  Thresholds pin the measured round-2 values
with ~1.4x headroom: a perf change that degrades matching quality trips them.

(SURVEY.md section 4.6 property tests; VERDICT round-1 item 8.)
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from aswstereomatch_tpu.config import HARD_PIN_CFG, HARD_PINS, StereoConfig
from aswstereomatch_tpu.models import pipeline
from aswstereomatch_tpu.utils import evaluate, synthetic

# Bounds and base config are single-sourced in config.py (shared with the
# on-card smoke, chip_smoke.py).
CFG = StereoConfig(**HARD_PIN_CFG)
CASES = [(mode, CFG.replace(**over), bounds) for mode, over, bounds in HARD_PINS]


def _run(cfg, pair):
    disp = jax.jit(functools.partial(pipeline.match_pair, cfg=cfg))(
        jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    )
    nonocc = ~pair["occluded"]
    disp = np.asarray(disp)
    return (
        evaluate.bad_delta(disp, pair["gt"], 2.0, nonocc),
        float(np.abs(disp - pair["gt"])[nonocc].mean()),
    )


@pytest.mark.parametrize("mode,cfg,bounds", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("seed", [0, 1])
def test_hard_scene_accuracy_pinned(mode, cfg, bounds, seed):
    pair = synthetic.make_hard_pair(96, 160, 24, seed=seed)
    bad2, epe = _run(cfg, pair)
    bad2_max, epe_max = bounds[seed]
    assert bad2 <= bad2_max, f"{mode} seed{seed}: bad-2.0 {bad2:.4f} > {bad2_max}"
    assert epe <= epe_max, f"{mode} seed{seed}: EPE {epe:.3f} > {epe_max}"


def test_symmetric_beats_left_only_on_hard_scene():
    """Ordering invariant (BASELINE.md symmetric-vs-left-only table): the
    accuracy argument for the symmetric default must keep holding in the
    hard regime."""
    pair = synthetic.make_hard_pair(96, 160, 24, seed=1)
    bad2_sym, _ = _run(CFG, pair)
    bad2_lo, _ = _run(CFG.replace(asw_symmetric=False), pair)
    assert bad2_sym < bad2_lo


def test_slanted_plane_subpixel_quality():
    """Slanted-plane EPE is dominated by subpixel interpolation quality;
    measured ~0.11 px (round 2).  A parabola-refinement or triple-capture
    regression shows up here first."""
    pair = synthetic.make_slanted_pair(96, 160, 24, seed=0)
    disp = np.asarray(
        jax.jit(functools.partial(pipeline.match_pair, cfg=CFG))(
            jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
        )
    )
    epe = float(np.abs(disp - pair["gt"]).mean())
    bad1 = evaluate.bad_delta(disp, pair["gt"], 1.0, None)
    assert epe <= 0.16, f"slanted EPE {epe:.3f}"
    assert bad1 <= 0.005, f"slanted bad-1.0 {bad1:.4f}"


# --- Separable-vs-exact drift contract (north-star bad-2.0-delta form) ----
#
# The separable O(K) mode ships auto-routed; the approximation must track
# EXACT symmetric ASW within the bound the north star sets for us vs
# OpenCV.  Measured at KITTI scale (round 3) the raw two-map delta is
# regime-dependent — on adversarial hard scenes exact and separable pick
# different arbitrary minima where the problem is ambiguous and exact is
# itself wrong (raw delta 3-5%, but 0.5-0.7% on the pixels exact gets
# right, with GT accuracy within 0.11pp) — so the contract is three bounds:
#   (1) smooth/natural scenes: raw delta <= 1% (north-star form),
#   (2) hard scenes: delta restricted to exact-correct pixels <= 1%,
#   (3) hard scenes: GT-accuracy cost (sep bad-2.0 - exact bad-2.0) <= 0.3pp.
# Two layers of pinning:
#   - live, CI-scale (96x160, D=24) on every run, both weight modes;
#   - the committed KITTI-geometry record (bench_results/
#     sep_vs_exact_kitti.json, produced on the GPU by
#     tools/pin_sep_accuracy.py — exact ASW at KITTI takes >9 min/pair on
#     CPU, so production scale cannot run live here).  The record's config
#     hashes are re-derived at test time: a config-surface change
#     invalidates the record and fails the test until the pin is re-run on
#     the card.

# Single-source bounds shared with the measurement tool
# (tools/pin_sep_accuracy.py) via config.SEP_CONTRACT.
from aswstereomatch_tpu.config import SEP_CONTRACT

SEP_DELTA_BOUND = SEP_CONTRACT["delta_bad2_max"]
SEP_GT_COST_BOUND = SEP_CONTRACT["gt_bad2_cost_max"]


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "leftonly"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_separable_tracks_exact_live(symmetric, seed):
    from aswstereomatch_tpu.utils import evaluate as ev

    cfg_e = CFG.replace(asw_symmetric=symmetric)
    cfg_s = cfg_e.replace(asw_separable=True)

    def run(cfg, pair):
        return np.asarray(
            jax.jit(functools.partial(pipeline.match_pair, cfg=cfg))(
                jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
            )
        )

    # (1) smooth scene: raw north-star-form delta
    pair = synthetic.make_pair(height=96, width=160, max_disparity=24,
                               seed=seed)
    raw = ev.bad_delta_between(
        run(cfg_s, pair), run(cfg_e, pair), 2.0, ~pair["occluded"]
    )
    assert raw <= SEP_DELTA_BOUND, (
        f"separable drifted from exact on smooth scene: {raw:.4%} > 1%"
    )
    # (2)+(3) hard scene: exact-correct-restricted delta + GT parity
    pair = synthetic.make_hard_pair(96, 160, 24, seed=seed)
    nonocc = ~pair["occluded"]
    de, ds = run(cfg_e, pair), run(cfg_s, pair)
    restr = ev.bad_delta_between(
        ds, de, 2.0, nonocc & (np.abs(de - pair["gt"]) <= 2.0)
    )
    assert restr <= SEP_DELTA_BOUND, (
        f"separable loses exact-correct pixels: {restr:.4%} > 1%"
    )
    cost = ev.bad_delta(ds, pair["gt"], 2.0, nonocc) - ev.bad_delta(
        de, pair["gt"], 2.0, nonocc
    )
    assert cost <= SEP_GT_COST_BOUND, (
        f"separable GT-accuracy cost {cost * 100:.3f}pp > 0.3pp"
    )


def test_separable_vs_exact_kitti_record():
    import json
    import os

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "bench_results", "sep_vs_exact_kitti.json",
    )
    assert os.path.exists(path), (
        "KITTI-scale separable pin record missing; run "
        "tools/pin_sep_accuracy.py on the GPU and commit the JSON"
    )
    with open(path) as f:
        rec = json.load(f)
    base = dict(
        max_disparity=128, cost="tad_grad", aggregation="asw",
        window_radius=16, lr_check=True, fill_holes=True, subpixel=True,
        median_filter=True,
    )
    assert rec["config_hash_exact"] == StereoConfig(**base).config_hash(), (
        "config surface changed since the KITTI pin was measured; re-run "
        "tools/pin_sep_accuracy.py on the GPU and commit the record"
    )
    assert rec["config_hash_sep"] == StereoConfig(
        **base, asw_separable=True
    ).config_hash()
    smooth = [r for r in rec["rows"] if r["regime"] == "smooth"]
    hard = [r for r in rec["rows"] if r["regime"] == "hard"]
    assert len(smooth) >= 3 and len(hard) >= 3, (
        "contract requires >= 3 seeds per regime"
    )
    for r in smooth:
        assert r["delta_bad2_vs_exact"] <= SEP_DELTA_BOUND, (
            f"smooth seed {r['seed']}: raw delta "
            f"{r['delta_bad2_vs_exact']:.4%} > 1%"
        )
    for r in hard:
        assert r["delta_bad2_on_exact_correct"] <= SEP_DELTA_BOUND, (
            f"hard seed {r['seed']}: exact-correct delta "
            f"{r['delta_bad2_on_exact_correct']:.4%} > 1%"
        )
        assert r["gt_bad2_cost"] <= SEP_GT_COST_BOUND, (
            f"hard seed {r['seed']}: GT cost "
            f"{r['gt_bad2_cost'] * 100:.3f}pp > 0.3pp"
        )
