"""Post-processing (SURVEY.md section 1, L5) in JAX.

Left-right consistency via cost-volume reuse (C_R(x,d) = C_L(x+d,d),
SURVEY.md section 3.3), hole filling with background bias, and a final 3x3
median — all static-shape, scan-free formulations:

  - the LR gather ``dispR[x - round(dispL)]`` is a take_along_axis along x;
  - nearest-valid-left/right fill uses running maximums of valid indices
    (``lax.cummax``-style) instead of a sequential scan, so it vectorizes and
    tiles trivially (rows are independent — the pinned spec is per-row).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..config import StereoConfig


def right_volume(vol: jnp.ndarray) -> jnp.ndarray:
    """C_R(x', d) = C_L(x' + d, d) by volume reuse; candidates with
    x' + d > W - 1 have no left pixel and are excluded (+inf).  vol: (H, W, D).

    Gather-free log-shear: log2(D) whole-volume roll+select passes in
    place of a take_along_axis gather (whether the gather form is faster
    on the GPU is an open ROADMAP item).  Each output stays in range of
    the inf-padded plane
    (x + d <= W + D - 2), so no roll wrap ever reaches a kept position —
    element-identical to the direct gather.
    """
    h, w, D = vol.shape
    m = jnp.pad(
        vol, ((0, 0), (0, D - 1), (0, 0)), constant_values=jnp.inf
    )
    d = jnp.arange(D)[None, None, :]
    b = 1
    while b < D:
        m = jnp.where((d & b) != 0, jnp.roll(m, -b, axis=1), m)
        b *= 2
    return m[:, :w, :].astype(jnp.float32)


def lr_check(
    disp_l: jnp.ndarray, disp_r: jnp.ndarray, cfg: StereoConfig
) -> jnp.ndarray:
    """Validity mask per the pinned spec.  Inputs are (H, W) float or int;
    disparities outside [0, D) are invalid by definition (mirrors the
    NumPy oracle — WTA only produces [0, D), and a value outside the
    searched range has no matching candidate).

    The gather ``dispR[x - round(dispL)]`` is data-dependent along x.
    With ``round(dispL)`` bounded by D, it is written as a D-step select
    over statically shifted
    planes (exact: pure selection, no arithmetic change), compiled as one
    fori over a (H, W+D) padded plane."""
    h, w = disp_l.shape
    D = cfg.max_disparity
    dl = disp_l.astype(jnp.float32)
    dli = jnp.round(dl).astype(jnp.int32)
    xr = jnp.arange(w)[None, :] - dli
    in_range = (xr >= 0) & (xr < w) & (dli >= 0) & (dli < D)
    # drp[:, D - d : D - d + w][y, x] = dispR[y, x - d] (left-padded; the
    # pad value is never selected: x - d < 0 implies in_range is False).
    drp = jnp.pad(disp_r.astype(jnp.float32), ((0, 0), (D, 0)))

    def body(d, acc):
        sel = lax.dynamic_slice(drp, (0, D - d), (h, w))
        return jnp.where(dli == d, sel, acc)

    dr = lax.fori_loop(0, D, body, jnp.zeros((h, w), jnp.float32))
    return in_range & (jnp.abs(dl - dr) <= cfg.lr_tol)


def fill_holes(disp: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Invalid pixels take min(nearest valid left, nearest valid right).

    Per-row; one-sided at row edges; rows with no valid pixel fill with 0.

    Formulated as log-depth associative "last valid VALUE" scans instead
    of cummax-of-index + take_along_axis (no data-dependent gathers).
    Pure selection — values are bit-identical to the gather
    form and the NumPy oracle."""
    dispf = disp.astype(jnp.float32)
    big = jnp.float32(jnp.inf)

    def last_valid(vals, mask):
        def combine(a, b):
            av, am = a
            bv, bm = b
            return jnp.where(bm, bv, av), am | bm

        return lax.associative_scan(combine, (vals, mask), axis=1)

    dl, has_l = last_valid(dispf, valid)
    dr_rev, has_r_rev = last_valid(dispf[:, ::-1], valid[:, ::-1])
    dr, has_r = dr_rev[:, ::-1], has_r_rev[:, ::-1]

    fill = jnp.minimum(
        jnp.where(has_l, dl, big), jnp.where(has_r, dr, big)
    )
    fill = jnp.where(jnp.isinf(fill), 0.0, fill)
    return jnp.where(valid, dispf, fill)


def median3(disp: jnp.ndarray) -> jnp.ndarray:
    """3x3 median, replicate border — final smoothing stage."""
    pad = jnp.pad(disp, ((1, 1), (1, 1)), mode="edge")
    h, w = disp.shape
    taps = jnp.stack(
        [pad[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)],
        axis=-1,
    )
    return jnp.sort(taps, axis=-1)[..., 4].astype(jnp.float32)


def weighted_median3(
    disp: jnp.ndarray, guide_lab: jnp.ndarray, cfg: StereoConfig
) -> jnp.ndarray:
    """Bilateral-guided 3x3 weighted median (config.py pinned spec).

    Weights come from the left image's Lab planes (the aggregation guidance),
    ``exp(-dLab/gamma_c - |o|/gamma_p)``; taps are sorted ascending by
    disparity (stable) and the output is the first value whose cumulative
    weight reaches half the total — the standard occlusion-edge-preserving
    refinement of the plain median (reference capability: SURVEY.md section
    2.1 "Median/weighted-median filter").

    Sort-free formulation (no argsort + take_along_axis gather over the
    9-tap axis): each tap's cumulative-in-sorted-order
    weight is computed directly as a masked sum — cum_i = sum_j w_j over
    {(v_j, j) <= (v_i, i) lexicographically} — and the answer is the
    smallest qualifying value.  Pure selection over the same weights
    (summation order differs from the sorted cumsum, so exact ties can
    flip within f32 ulps — the same tolerance the oracle-parity test
    already grants the old form vs the f64 oracle).
    """
    import numpy as np

    h, w = disp.shape
    pd = jnp.pad(disp, ((1, 1), (1, 1)), mode="edge")
    pg = jnp.pad(guide_lab, ((1, 1), (1, 1), (0, 0)), mode="edge")
    vals = []
    wgts = []
    for dy in range(3):
        for dx in range(3):
            vals.append(pd[dy : dy + h, dx : dx + w])
            dlab = jnp.sqrt(
                jnp.sum(
                    (pg[dy : dy + h, dx : dx + w] - guide_lab) ** 2, axis=-1
                )
            )
            sp = np.float32(
                np.hypot(dy - 1, dx - 1) / cfg.gamma_spatial
            )
            wgts.append(jnp.exp(-dlab / cfg.gamma_color - sp))
    cums = []
    for i in range(9):
        c = None
        for j in range(9):
            # stable order: ties (v_j == v_i) count only for j <= i
            sel = vals[j] <= vals[i] if j <= i else vals[j] < vals[i]
            t = jnp.where(sel, wgts[j], 0.0)
            c = t if c is None else c + t
        cums.append(c)
    # The lexicographically-maximal tap's cum is the full j-order sum, so
    # using max(cums) as the total guarantees at least one tap qualifies.
    import functools

    half = 0.5 * functools.reduce(jnp.maximum, cums)
    out = jnp.full((h, w), jnp.inf, jnp.float32)
    for i in range(9):
        out = jnp.where(
            cums[i] >= half, jnp.minimum(out, vals[i]), out
        )
    return out.astype(jnp.float32)


def median_filter(
    disp: jnp.ndarray, cfg: StereoConfig, guide_lab: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Dispatch to the configured final median variant."""
    if cfg.median_mode == "weighted":
        if guide_lab is None:
            raise ValueError("weighted median needs the left-image Lab guide")
        return weighted_median3(disp, guide_lab, cfg)
    return median3(disp)
