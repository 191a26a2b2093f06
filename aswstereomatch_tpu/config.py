"""Canonical configuration for the stereo-matching engine.

This module pins the *numeric contract* of the whole framework: every stage of
the pipeline (preprocess -> cost -> aggregation -> WTA -> post-process) is
defined in terms of the parameters here, and the NumPy oracle
(`aswstereomatch_tpu.models.oracle_numpy`) and the vectorized JAX pipeline
(`aswstereomatch_tpu.models.pipeline`) must agree on the same config to f32
tolerance (tests enforce this).

Capability parity note (SURVEY.md section 2.1 "Parameter block"): the reference
(ZhangYY12345/aswStereoMatch, C++/OpenCV; mount empty at survey time, see
SURVEY.md section 0) carries a compiled-in parameter struct with window size,
disparity range, gamma_c / gamma_p, truncations tau1/tau2, blend alpha and an
LR tolerance.  ``StereoConfig`` is the JAX equivalent, extended with
mesh / tiling fields the single-process reference has no analog for
(SURVEY.md section 2.2).

Pinned numeric conventions (all implementations MUST follow these):
  - Images are float32 RGB in [0, 255] on the 8-bit integer grid, (H, W, 3).
  - Grayscale: Rec.601, ``0.299 R + 0.587 G + 0.114 B`` (matches cv2 RGB2GRAY).
  - x-gradient: central difference ``g(x) = I(x+1) - I(x-1)`` on grayscale with
    replicate border (matches ``cv2.Sobel(..., ksize=1)`` + BORDER_REPLICATE).
  - **Virtual padded-plane border semantics**: all out-of-image accesses read
    edge-replicated (replicate-border) virtual planes with *unclamped
    arithmetic indices* — conceptually ``Lp = pad_edge(left, r)`` in x/y and
    ``Rp = pad_edge(right, (r + D - 1, r))`` in x — rather than re-clamping
    composed coordinates.  This makes every access in every stage a pure
    shift (no gathers), so the loop oracle, the vectorized jnp path and its
    tiled/sharded layouts agree by construction.
  - AD cost: ``C(x, d) = mean_c |Lp_c(x) - Rp_c(x - d)|``, defined for the
    x-extended domain ``x in [-r, W-1+r]`` that aggregation taps.
  - TAD+grad cost: ``alpha * min(AD, tau1) + (1-alpha) * min(|gLp - gRp|, tau2)``.
  - Box aggregation: mean over the (2r+1)^2 window; x taps hit the extended
    cost domain, y taps the edge-replicated rows.
  - ASW weights (Yoon-Kweon TPAMI 2006): CIELab color distance, D65, sRGB
    gamma; ``w(p,q) = exp(-dLab(p,q)/gamma_c - |p-q|_2/gamma_p)`` with the
    spatial term from the *nominal* window offset; left weights from Lp,
    right weights from Rp centered at ``x - d``; symmetric two-view product
    ``wL * wR`` unless ``asw_symmetric=False``.
  - WTA: first-occurrence argmin over d.
  - Subpixel: parabola ``d* = d - (C+ - C-)/(2 (C+ - 2 C0 + C-))``, offset
    clamped to [-0.5, 0.5], only applied for 0 < d < D-1 and |denom| > 1e-6.
  - Right disparity by volume reuse: ``C_R(x', d) = C_L(x' + d, d)`` where
    candidates with ``x' + d > W - 1`` are **excluded** from the argmin
    (no left pixel exists for them).
  - LR check: valid iff ``x - round(dL) >= 0`` and
    ``|dL(x) - dR(x - round(dL(x)))| <= lr_tol``.
  - Fill: per-row, each invalid pixel takes ``min(nearest valid to the left,
    nearest valid to the right)`` (background bias); one-sided at row edges.
  - Median: 3x3 median on the float disparity map, replicate border, last.
  - Weighted median ("weighted" mode): 3x3 window; weights
    ``exp(-dLab(center, tap)/gamma_c - |o|_2/gamma_p)`` from the LEFT image
    (edge-replicated taps, nominal-offset spatial term); taps sorted
    ascending by disparity (stable); output is the first tap value whose
    cumulative weight reaches half the total.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Frozen parameter block for one stereo-matching run.

    Mirrors (and supersedes) the reference's compiled-in parameter struct
    (SURVEY.md section 2.1); adds the device mesh / tiling configuration.
    """

    # ---- geometry -----------------------------------------------------------
    max_disparity: int = 64            # D: candidate disparities are [0, D)
    # ---- cost (L2 in SURVEY section 1) --------------------------------------
    cost: str = "tad_grad"             # "ad" | "tad_grad"
    tau_color: float = 40.0            # tau1: truncation of the color AD term
    tau_grad: float = 10.0             # tau2: truncation of the gradient term
    alpha: float = 0.9                 # blend: alpha*AD + (1-alpha)*grad
    # ---- aggregation (L3) ---------------------------------------------------
    aggregation: str = "asw"           # "none" | "box" | "asw" | "sgm"
    window_radius: int = 16            # r: window is (2r+1) x (2r+1)
    gamma_color: float = 14.0          # gamma_c: Lab color bandwidth (ASW)
    gamma_spatial: float = 31.0        # gamma_p: spatial bandwidth (ASW)
    asw_symmetric: bool = True         # two-view (wL*wR) vs left-only weights
    # Semi-global aggregation (aggregation="sgm" — a beyond-reference
    # extension, round 5): 4-path scanline cost propagation (Hirschmuller
    # 2008) over the RAW cost volume instead of a local window.  Pinned
    # recurrence, per path direction r with predecessor q = p - r:
    #   L_r(p,d) = C(p,d) + min(L_r(q,d), L_r(q,d-1)+P1, L_r(q,d+1)+P1,
    #                           min_d' L_r(q,d') + P2) - min_d' L_r(q,d')
    #   (first pixel of each scan: L_r = C; out-of-range d+-1 terms +inf)
    #   S = sum over r in {left-to-right, right-to-left, top-down,
    #   bottom-up}, in that order.  S feeds WTA/subpixel/LR/uniqueness
    #   like any aggregated volume.  Scans propagate globally, so the
    #   sharded/chunked layouts reject this mode (documented).
    sgm_p1: float = 8.0                # small-slant penalty (|dd| = 1)
    sgm_p2: float = 32.0               # discontinuity penalty (|dd| > 1);
                                       # defaults from the round-5 hard-
                                       # regime sweep (plateau at 8/32 on
                                       # the TAD cost scale, max ~37)
    sgm_paths: int = 4                 # 4 (axial) | 8 (+ diagonals, cv2
                                       # MODE_HH-class).  8-path order
                                       # (pinned): axial sum, then
                                       # (1,1), (1,-1), (-1,1), (-1,-1);
                                       # diagonal first-pixel rule: no
                                       # in-image predecessor -> L = C
    asw_separable: bool = False        # two-pass (vertical then horizontal)
                                       # separable approximation of the ASW
                                       # window: O(K) taps instead of O(K^2).
                                       # An approximation, not the exact
                                       # Yoon-Kweon sum — a documented speed
                                       # mode (spatial term becomes
                                       # exp(-(|dy|+|dx|)/gamma_p); color
                                       # path runs through the window cross)
    # ---- post-processing (L5) ----------------------------------------------
    lr_check: bool = True
    lr_tol: float = 1.0                # max |dL - dR| to accept a pixel
    uniqueness_ratio: float = 0.0      # WTA-uniqueness confidence gate (the
                                       # knob cv2.StereoBM/SGBM ship): reject
                                       # a pixel unless the second-best
                                       # aggregated cost over d outside
                                       # [best-1, best+1] exceeds the best by
                                       # this percentage margin —
                                       # second*100 >= best*(100+ratio).
                                       # 0.0 (default) disables the gate.
                                       # Rejected pixels follow fill_holes
                                       # like LR failures (filled, or -1).
    fill_holes: bool = True
    subpixel: bool = True
    median_filter: bool = True         # final 3x3 median
    median_mode: str = "plain"         # "plain" | "weighted" (bilateral-
                                       # guided 3x3 weighted median)
    # ---- memory -------------------------------------------------------------
    y_chunks: int = 1                  # >1: stream row bands sequentially per
                                       # device (bounds peak HBM; bit-exact)
    # ---- parallelism (SURVEY section 2.2; no reference analog) --------------
    # Deployment layout consumed by parallel.mesh.mesh_from_config /
    # parallel.api.sharded_matcher: how many devices along each mesh axis and
    # which image axis "tile" shards ("d" = disparity-axis sharding).
    mesh_data: int = 1                 # devices along the batch ("data") axis
    mesh_tile: int = 1                 # devices along the spatial ("tile") axis
    tile_axis: str = "y"               # what "tile" shards: "y" | "x" | "d"

    def __post_init__(self):
        if self.cost not in ("ad", "tad_grad"):
            raise ValueError(f"unknown cost {self.cost!r}")
        if self.aggregation not in ("none", "box", "asw", "sgm"):
            raise ValueError(f"unknown aggregation {self.aggregation!r}")
        if self.aggregation == "sgm":
            if self.sgm_p1 < 0 or self.sgm_p2 < self.sgm_p1:
                raise ValueError("require 0 <= sgm_p1 <= sgm_p2")
            if self.sgm_paths not in (4, 8):
                raise ValueError("sgm_paths must be 4 or 8")
        if self.tile_axis not in ("y", "x", "d"):
            raise ValueError("tile_axis must be 'y', 'x' or 'd'")
        if self.max_disparity < 1:
            raise ValueError("max_disparity must be >= 1")
        if self.uniqueness_ratio < 0:
            raise ValueError("uniqueness_ratio must be >= 0")
        if self.window_radius < 0:
            raise ValueError("window_radius must be >= 0")
        if self.median_mode not in ("plain", "weighted"):
            raise ValueError(f"unknown median_mode {self.median_mode!r}")
        if self.asw_separable and self.aggregation != "asw":
            raise ValueError("asw_separable requires aggregation='asw'")

    # -- derived --------------------------------------------------------------
    @property
    def window_size(self) -> int:
        return 2 * self.window_radius + 1

    @property
    def halo_y(self) -> int:
        """Rows of image halo a y-tile needs on each side for exact tiling.

        window_radius for aggregation + 1 for the final 3x3 median.  The cost
        stage (central-difference x-gradient) has no y extent.
        """
        r = self.window_radius if self.aggregation != "none" else 0
        return r + (1 if self.median_filter else 0)

    @property
    def halo_x(self) -> Tuple[int, int]:
        """(left, right) columns of image halo an x-tile needs.

        The left channel stack needs the aggregation radius each side; the
        right stack additionally needs ``max_disparity - 1`` columns of left
        halo (the matching window reaches x - D + 1) — see
        ``parallel/tiling.py::match_pair_tiled_x``.
        """
        r = self.window_radius if self.aggregation != "none" else 0
        return (r + self.max_disparity - 1, r)

    def config_hash(self) -> str:
        """Stable short hash for observability / manifest keys."""
        payload = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:12]

    def replace(self, **kw) -> "StereoConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# The five BASELINE.json configs, pinned as named presets (SURVEY section 5
# "Config / flag system").  Geometry of the datasets:
#   Tsukuba 384x288 D=16; Venus/Teddy/Cones 450x375 D=64; KITTI 1242x375 D=128.
# ---------------------------------------------------------------------------

# Separable-mode accuracy contract vs exact ASW at production (KITTI)
# geometry — the single source for both the measurement tool
# (tools/pin_sep_accuracy.py) and the pinned test
# (tests/test_accuracy_regression.py), so the two can never drift apart:
#   delta_bad2_max: smooth-scene raw separable-vs-exact bad-2.0 delta AND
#                   hard-scene delta restricted to exact-correct pixels;
#   gt_bad2_cost_max: hard-scene GT-accuracy cost (sep - exact bad-2.0).
SEP_CONTRACT = {"delta_bad2_max": 0.01, "gt_bad2_cost_max": 0.003}

# Hard-scene accuracy pins (``synthetic.make_hard_pair(96, 160, 24, seed)``)
# — the single source for tests/test_accuracy_regression.py and the on-card
# smoke (chip_smoke.py).  HARD_PIN_CFG is the base; each mode lists its
# overrides and per-seed (bad2_max, epe_max).  Measured values, with ~1.4x
# headroom:
#   sym      b2 = 1.60 / 4.70 / 1.83 %,  epe = 0.19 / 0.44 / 0.27
#   leftonly b2 = 2.41 / 6.75 / 2.64 %,  epe = 0.27 / 0.73 / 0.37
#   box      b2 = 4.91 / 8.55 / 4.96 %,  epe = 0.51 / 0.92 / 0.57
#   sepsym   b2 = 1.68 / 4.57 / 1.87 %,  epe = 0.18 / 0.39 / 0.28 — within
#            noise of exact sym; the approximation must KEEP tracking exact,
#            hence same-headroom pins.
HARD_PIN_CFG = dict(
    max_disparity=24, cost="tad_grad", aggregation="asw", window_radius=8,
    lr_check=True, fill_holes=True, subpixel=True, median_filter=True,
)
HARD_PINS = [
    ("sym", {}, {0: (0.023, 0.28), 1: (0.066, 0.62), 2: (0.026, 0.38)}),
    ("leftonly", {"asw_symmetric": False},
     {0: (0.034, 0.39), 1: (0.095, 1.03), 2: (0.037, 0.52)}),
    ("box", {"aggregation": "box"},
     {0: (0.069, 0.72), 1: (0.120, 1.30), 2: (0.070, 0.80)}),
    ("sepsym", {"asw_separable": True},
     {0: (0.024, 0.26), 1: (0.064, 0.55), 2: (0.027, 0.39)}),
    ("seplo", {"asw_separable": True, "asw_symmetric": False},
     {0: (0.027, 0.30), 1: (0.087, 0.93), 2: (0.032, 0.45)}),
]

PRESETS = {
    # BASELINE config 1: "Tsukuba (384x288, D=16), AD cost + fixed-window
    # aggregation - CPU-runnable PR1 ref"
    "tsukuba_ad_box": StereoConfig(
        max_disparity=16,
        cost="ad",
        aggregation="box",
        window_radius=4,
        lr_check=False,
        fill_holes=False,
        subpixel=False,
        median_filter=False,
    ),
    # BASELINE config 2: "Venus/Teddy/Cones (450x375, D=64) with full
    # TAD+gradient cost and ASW aggregation"
    "middlebury_asw": StereoConfig(
        max_disparity=64,
        cost="tad_grad",
        aggregation="asw",
        window_radius=16,
        lr_check=False,
        fill_holes=False,
        subpixel=False,
        median_filter=False,
    ),
    # BASELINE config 3: "ASW with large support windows (33x33) + LR
    # consistency and subpixel refine on Middlebury full set"
    "middlebury_asw_full": StereoConfig(
        max_disparity=64,
        cost="tad_grad",
        aggregation="asw",
        window_radius=16,
        lr_check=True,
        fill_holes=True,
        subpixel=True,
        median_filter=True,
    ),
    # BASELINE config 4: "KITTI stereo pair (1242x375, D=128), tiled cost
    # volume with halo exchange on one host"
    "kitti_tiled": StereoConfig(
        max_disparity=128,
        cost="tad_grad",
        aggregation="asw",
        window_radius=16,
        lr_check=True,
        fill_holes=True,
        subpixel=True,
        median_filter=True,
        mesh_tile=4,
    ),
    # BASELINE config 5: "Batched KITTI sequence throughput (batch>=16 pairs)
    # sharded across N>=2 hosts"
    "kitti_batch": StereoConfig(
        max_disparity=128,
        cost="tad_grad",
        aggregation="asw",
        window_radius=16,
        lr_check=True,
        fill_holes=True,
        subpixel=True,
        median_filter=True,
        mesh_data=2,
        mesh_tile=4,
    ),
    # Separable symmetric ASW at KITTI geometry: the O(K) speed mode.
    # Accuracy-contracted vs exact ASW three ways at KITTI scale
    # (tests/test_accuracy_regression.py; bench_results/
    # sep_vs_exact_kitti.json).
    "kitti_sep": StereoConfig(
        max_disparity=128,
        cost="tad_grad",
        aggregation="asw",
        window_radius=16,
        asw_separable=True,
        lr_check=True,
        fill_holes=True,
        subpixel=True,
        median_filter=True,
        mesh_tile=4,
    ),
    # Separable LEFT-ONLY ASW at KITTI geometry.  Left-only weights are an
    # approximation of Yoon-Kweon's symmetric weighting (SURVEY §7 "decide
    # by measurement"); accuracy pinned on the hard regime in
    # tests/test_accuracy_regression.py ("seplo" rows).
    "kitti_seplo": StereoConfig(
        max_disparity=128,
        cost="tad_grad",
        aggregation="asw",
        window_radius=16,
        asw_separable=True,
        asw_symmetric=False,
        lr_check=True,
        fill_holes=True,
        subpixel=True,
        median_filter=True,
        mesh_tile=4,
    ),
    # Semi-global mode (round 5, beyond-reference extension): 4-path
    # scanline propagation over the raw TAD+grad cost — the accuracy mode
    # for ambiguous/low-texture content where local windows (ASW incl.)
    # saturate: kitti-geometry hard regime DENSE bad-2.0 1.4%/0.5%
    # (2 seeds) vs local ASW dense 11% and cv2 SGBM 4.3% at 0.88
    # coverage.  Scans are global: no spatial tiling/chunking (documented).
    "kitti_sgm": StereoConfig(
        max_disparity=128,
        cost="tad_grad",
        aggregation="sgm",
        lr_check=True,
        fill_holes=True,
        subpixel=True,
        median_filter=True,
    ),
}


def get_preset(name: str) -> StereoConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        ) from None
