"""Literal NumPy oracle for the full stereo pipeline.

This is the in-repo golden: a direct, loop-level transcription of the pinned
numeric spec in ``config.py`` — the same role the reference's C++ inner loops
play (SURVEY.md section 3.1/3.2), written for *obvious correctness*, not
speed.  Use only on small images/crops; every vectorized JAX stage must
match it to f32 tolerance (tests/test_oracle_parity.py,
tests/test_jnp_vs_oracle_*.py).

The ASW aggregation below is the 5-deep loop (y, x, d, wy, wx) of
Yoon-Kweon TPAMI 2006 section 3 with symmetric two-view weights:

    w(p, q)   = exp(-||Lab(p)-Lab(q)||_2 / gamma_c - ||p-q||_2 / gamma_p)
    E(p, d)   = sum_q wL(p,q) * wR(p-d, q-d) * e(q, q-d) / sum_q wL*wR
"""

from __future__ import annotations

import numpy as np

from ..config import StereoConfig
from ..utils import colorspace


# ---------------------------------------------------------------------------
# Stage implementations (all replicate-border, per the pinned spec)
# ---------------------------------------------------------------------------

def gray_and_grad(img: np.ndarray):
    gray = colorspace.rgb_to_gray(img, np) if img.ndim == 3 else img.astype(np.float32)
    h, w = gray.shape
    grad = np.empty_like(gray)
    for x in range(w):
        xm = max(x - 1, 0)
        xp = min(x + 1, w - 1)
        grad[:, x] = gray[:, xp] - gray[:, xm]
    return gray, grad


def _pad_x(arr: np.ndarray, left: int, right: int) -> np.ndarray:
    widths = [(0, 0), (left, right)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, widths, mode="edge")


def cost_volume_ext(
    left: np.ndarray, right: np.ndarray, cfg: StereoConfig, rx: int
) -> np.ndarray:
    """Raw cost C[y, j, d] on the x-extended domain x in [-rx, W-1+rx].

    Virtual padded-plane semantics (config.py): Lp edge-padded by rx,
    Rp edge-padded by rx + D - 1 on the left / rx on the right; the cost at
    extended column j (left x = j - rx) reads Rp at x - d unclamped.
    """
    h, w = left.shape[:2]
    D = cfg.max_disparity
    lc = left if left.ndim == 3 else left[..., None]
    rc = right if right.ndim == 3 else right[..., None]
    _, gl = gray_and_grad(left)
    _, gr = gray_and_grad(right)
    lp, gl_p = _pad_x(lc, rx, rx), _pad_x(gl, rx, rx)
    rp, gr_p = _pad_x(rc, rx + D - 1, rx), _pad_x(gr, rx + D - 1, rx)
    we = w + 2 * rx
    vol = np.zeros((h, we, D), np.float32)
    for d in range(D):
        for j in range(we):
            jr = j + (D - 1) - d  # right-plane index of x - d
            ad = np.abs(lp[:, j, :] - rp[:, jr, :]).mean(axis=-1)
            if cfg.cost == "ad":
                vol[:, j, d] = ad
            else:
                gd = np.abs(gl_p[:, j] - gr_p[:, jr])
                vol[:, j, d] = cfg.alpha * np.minimum(
                    ad, cfg.tau_color
                ) + (1.0 - cfg.alpha) * np.minimum(gd, cfg.tau_grad)
    return vol


def cost_volume(left: np.ndarray, right: np.ndarray, cfg: StereoConfig) -> np.ndarray:
    """Raw cost volume C[y, x, d] on the image domain."""
    return cost_volume_ext(left, right, cfg, 0)


def aggregate_box(vol_ext: np.ndarray, cfg: StereoConfig) -> np.ndarray:
    """Mean over (2r+1)^2 window.  vol_ext: x-extended cost (H, W+2r, D).

    x taps hit the extended domain unclamped; y taps the replicated rows
    (equivalently: clamped, since cost is pointwise in y).
    """
    h, we, D = vol_ext.shape
    r = cfg.window_radius
    w = we - 2 * r
    out = np.zeros((h, w, D), np.float32)
    for y in range(h):
        for x in range(w):
            acc = np.zeros(D, np.float64)
            for wy in range(-r, r + 1):
                for wx in range(-r, r + 1):
                    yy = min(max(y + wy, 0), h - 1)
                    acc += vol_ext[yy, r + x + wx]
            out[y, x] = acc / float((2 * r + 1) ** 2)
    return out.astype(np.float32)


def asw_weight(
    lab: np.ndarray, y: int, x: int, yy: int, xx: int, wy: int, wx: int, cfg: StereoConfig
) -> float:
    """Yoon-Kweon bilateral weight.

    Color term uses the (border-clamped) tap pixel; the spatial term uses the
    *nominal* window offset (wy, wx) — pinned so that border behavior equals
    edge-padding + fixed per-offset spatial weight in the vectorized path.
    """
    dc = float(np.sqrt(((lab[y, x] - lab[yy, xx]) ** 2).sum()))
    dg = float(np.sqrt(wy * wy + wx * wx))
    return float(np.exp(-dc / cfg.gamma_color - dg / cfg.gamma_spatial))


def aggregate_asw(
    vol_ext: np.ndarray, left: np.ndarray, right: np.ndarray, cfg: StereoConfig
) -> np.ndarray:
    """Yoon-Kweon adaptive-support-weight aggregation, literal 5-loop form.

    Virtual padded-plane semantics: x-accesses index edge-padded planes with
    unclamped arithmetic (left Lab padded by r; right Lab by r + D - 1 / r;
    cost on the x-extended domain); y taps clamp (== replicated rows, cost
    and weights being pointwise in y).  vol_ext: (H, W+2r, D).
    """
    h, we, D = vol_ext.shape
    r = cfg.window_radius
    w = we - 2 * r
    lab_l = _pad_x(colorspace.rgb_to_lab(left, np), r, r)
    lab_r = _pad_x(colorspace.rgb_to_lab(right, np), r + D - 1, r)
    out = np.zeros((h, w, D), np.float32)
    for y in range(h):
        for x in range(w):
            for d in range(D):
                jl = x + r            # center in lab_l
                jr = x - d + r + D - 1  # center x-d in lab_r
                num = 0.0
                den = 0.0
                for wy in range(-r, r + 1):
                    for wx in range(-r, r + 1):
                        yy = min(max(y + wy, 0), h - 1)
                        wl = asw_weight(
                            lab_l, y, jl, yy, jl + wx, wy, wx, cfg
                        )
                        if cfg.asw_symmetric:
                            wr_ = asw_weight(
                                lab_r, y, jr, yy, jr + wx, wy, wx, cfg
                            )
                        else:
                            wr_ = 1.0
                        wgt = wl * wr_
                        num += wgt * vol_ext[yy, r + x + wx, d]
                        den += wgt
                out[y, x, d] = num / den
    return out.astype(np.float32)


def _asw_weight_1d(
    lab: np.ndarray, y: int, j: int, yy: int, jj: int, o: int, cfg: StereoConfig
) -> float:
    """1D bilateral factor for the separable passes: color term between the
    (clamped-y) tap and the pass center, spatial term exp(-|o|/gamma_p)."""
    dc = float(np.sqrt(((lab[y, j] - lab[yy, jj]) ** 2).sum()))
    return float(np.exp(-dc / cfg.gamma_color - abs(o) / cfg.gamma_spatial))


def aggregate_asw_separable(
    vol_ext: np.ndarray, left: np.ndarray, right: np.ndarray, cfg: StereoConfig
) -> np.ndarray:
    """Two-pass separable ASW, literal loop form (the ``asw_separable``
    speed-mode spec): a vertical bilateral pass over the x-extended cost,
    then a horizontal bilateral pass; symmetric mode multiplies the
    right-view factor into both passes.  Same virtual padded-plane border
    semantics as ``aggregate_asw``.
    """
    h, we, D = vol_ext.shape
    r = cfg.window_radius
    w = we - 2 * r
    lab_l = _pad_x(colorspace.rgb_to_lab(left, np), r, r)
    lab_r = _pad_x(colorspace.rgb_to_lab(right, np), r + D - 1, r)
    out = np.zeros((h, w, D), np.float32)
    numv = np.zeros((h, we), np.float64)
    denv = np.zeros((h, we), np.float64)
    for d in range(D):
        for y in range(h):
            for u in range(we):        # vertical pass on extended columns
                jr = u - d + D - 1     # center u-r-d+... in lab_r coords:
                # lab_l col u <-> plane col u - r; lab_r center = (u-r) - d
                # + (r + D - 1) = u - d + D - 1.
                nv = dv = 0.0
                for wy in range(-r, r + 1):
                    yy = min(max(y + wy, 0), h - 1)
                    wgt = _asw_weight_1d(lab_l, y, u, yy, u, wy, cfg)
                    if cfg.asw_symmetric:
                        wgt *= _asw_weight_1d(lab_r, y, jr, yy, jr, wy, cfg)
                    nv += wgt * vol_ext[yy, u, d]
                    dv += wgt
                numv[y, u] = nv
                denv[y, u] = dv
        for y in range(h):
            for x in range(w):         # horizontal pass on true centers
                jl = x + r
                jr = x - d + r + D - 1
                num = den = 0.0
                for wx in range(-r, r + 1):
                    # taps beyond the extended plane replicate the edge
                    jj = min(max(jl + wx, 0), we - 1)
                    wgt = _asw_weight_1d(lab_l, y, jl, y, jl + wx, wx, cfg)
                    if cfg.asw_symmetric:
                        wgt *= _asw_weight_1d(lab_r, y, jr, y, jr + wx, wx, cfg)
                    num += wgt * numv[y, jj]
                    den += wgt * denv[y, jj]
                out[y, x, d] = num / den
    return out.astype(np.float32)


def wta(vol: np.ndarray) -> np.ndarray:
    return np.argmin(vol, axis=-1).astype(np.int32)


def subpixel(vol: np.ndarray, disp: np.ndarray) -> np.ndarray:
    h, w, D = vol.shape
    out = disp.astype(np.float32).copy()
    for y in range(h):
        for x in range(w):
            d = int(disp[y, x])
            if d <= 0 or d >= D - 1:
                continue
            c0, cm, cp = vol[y, x, d], vol[y, x, d - 1], vol[y, x, d + 1]
            denom = cp - 2.0 * c0 + cm
            if abs(denom) <= 1e-6:
                continue
            off = (cp - cm) / (2.0 * denom)
            out[y, x] = d - float(np.clip(off, -0.5, 0.5))
    return out


def right_volume(vol: np.ndarray) -> np.ndarray:
    """C_R(x', d) = C_L(x'+d, d) by volume reuse (SURVEY section 3.3).

    Candidates with x'+d > W-1 have no left pixel and are excluded from the
    argmin (+inf), per the pinned spec.
    """
    h, w, D = vol.shape
    out = np.full_like(vol, np.inf)
    for d in range(D):
        for x in range(w):
            if x + d <= w - 1:
                out[:, x, d] = vol[:, x + d, d]
    return out


def lr_check(disp_l: np.ndarray, disp_r: np.ndarray, cfg: StereoConfig) -> np.ndarray:
    """Validity mask: |dL(x) - dR(x - round(dL(x)))| <= lr_tol, x-d in range.

    Disparities outside [0, D) are invalid by definition (the WTA stage
    only produces [0, D); a value outside it has no matching candidate in
    the searched range) — pinned so the jnp implementation's bounded-D
    select form agrees on every input, not just WTA outputs."""
    h, w = disp_l.shape
    valid = np.zeros((h, w), bool)
    for y in range(h):
        for x in range(w):
            d = float(disp_l[y, x])
            di = int(round(d))
            if di < 0 or di >= cfg.max_disparity:
                continue
            xr = x - di
            if xr < 0 or xr >= w:
                continue
            if abs(d - float(disp_r[y, xr])) <= cfg.lr_tol:
                valid[y, x] = True
    return valid


def fill_holes(disp: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Invalid pixels take min(nearest valid left, nearest valid right)."""
    h, w = disp.shape
    out = disp.astype(np.float32).copy()
    BIG = np.float32(np.inf)
    for y in range(h):
        left_fill = np.full(w, BIG, np.float32)
        run = BIG
        for x in range(w):
            if valid[y, x]:
                run = out[y, x]
            left_fill[x] = run
        right_fill = np.full(w, BIG, np.float32)
        run = BIG
        for x in range(w - 1, -1, -1):
            if valid[y, x]:
                run = out[y, x]
            right_fill[x] = run
        for x in range(w):
            if not valid[y, x]:
                v = min(left_fill[x], right_fill[x])
                out[y, x] = 0.0 if np.isinf(v) else v
    return out


def weighted_median3(
    disp: np.ndarray, left: np.ndarray, cfg: StereoConfig
) -> np.ndarray:
    """Bilateral-guided 3x3 weighted median, literal form (config.py spec)."""
    h, w = disp.shape
    lab = colorspace.rgb_to_lab(left, np)
    out = np.empty_like(disp, dtype=np.float32)
    for y in range(h):
        for x in range(w):
            vals = []
            wgts = []
            for wy in (-1, 0, 1):
                for wx in (-1, 0, 1):
                    yy = min(max(y + wy, 0), h - 1)
                    xx = min(max(x + wx, 0), w - 1)
                    vals.append(disp[yy, xx])
                    dlab = float(np.sqrt(((lab[y, x] - lab[yy, xx]) ** 2).sum()))
                    sp = float(np.hypot(wy, wx)) / cfg.gamma_spatial
                    wgts.append(float(np.exp(-dlab / cfg.gamma_color - sp)))
            order = np.argsort(np.asarray(vals), kind="stable")
            v_s = np.asarray(vals, np.float32)[order]
            g_s = np.asarray(wgts, np.float64)[order]
            cum = np.cumsum(g_s)
            half = cum[-1] * 0.5
            k = int(np.argmax(cum >= half))
            out[y, x] = v_s[k]
    return out


def median3(disp: np.ndarray) -> np.ndarray:
    h, w = disp.shape
    out = np.empty_like(disp)
    for y in range(h):
        for x in range(w):
            vals = []
            for wy in (-1, 0, 1):
                for wx in (-1, 0, 1):
                    yy = min(max(y + wy, 0), h - 1)
                    xx = min(max(x + wx, 0), w - 1)
                    vals.append(disp[yy, xx])
            out[y, x] = np.sort(np.asarray(vals))[4]
    return out


def aggregate_sgm(vol: np.ndarray, cfg: StereoConfig) -> np.ndarray:
    """Literal 4-path semi-global aggregation (recurrence pinned in
    config.py): per direction r with predecessor q = p - r,
    L_r(p,d) = C(p,d) + min(L_r(q,d), L_r(q,d-1)+P1, L_r(q,d+1)+P1,
    min_d' L_r(q,d') + P2) - min_d' L_r(q,d'); S = sum over the four
    directions in the pinned order (l2r, r2l, t2b, b2t)."""
    h, w, D = vol.shape
    p1, p2 = np.float32(cfg.sgm_p1), np.float32(cfg.sgm_p2)
    out = np.zeros_like(vol, np.float32)
    dirs = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    if cfg.sgm_paths == 8:
        dirs += [(1, 1), (1, -1), (-1, 1), (-1, -1)]
    for dy, dx in dirs:
        L = np.zeros_like(vol, np.float32)
        ys = range(h) if dy >= 0 else range(h - 1, -1, -1)
        xs = range(w) if dx >= 0 else range(w - 1, -1, -1)
        for y in ys:
            for x in xs:
                py, px = y - dy, x - dx
                if not (0 <= py < h and 0 <= px < w):
                    L[y, x] = vol[y, x]
                    continue
                prev = L[py, px]
                pmin = np.float32(prev.min())
                for d in range(D):
                    cands = [prev[d], np.float32(pmin + p2)]
                    if d > 0:
                        cands.append(np.float32(prev[d - 1] + p1))
                    if d < D - 1:
                        cands.append(np.float32(prev[d + 1] + p1))
                    L[y, x, d] = np.float32(
                        vol[y, x, d] + min(cands) - pmin
                    )
        out = (out + L).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

def aggregated_volume(
    left: np.ndarray, right: np.ndarray, cfg: StereoConfig
) -> np.ndarray:
    """(H, W, D) aggregated cost volume per the configured aggregation."""
    if cfg.aggregation == "box":
        return aggregate_box(
            cost_volume_ext(left, right, cfg, cfg.window_radius), cfg
        )
    if cfg.aggregation == "sgm":
        return aggregate_sgm(cost_volume(left, right, cfg), cfg)
    if cfg.aggregation == "asw":
        agg = aggregate_asw_separable if cfg.asw_separable else aggregate_asw
        return agg(
            cost_volume_ext(left, right, cfg, cfg.window_radius),
            left, right, cfg,
        )
    return cost_volume(left, right, cfg)


def match_pair(left: np.ndarray, right: np.ndarray, cfg: StereoConfig) -> np.ndarray:
    """End-to-end oracle: images -> float32 disparity map (SURVEY section 3.1)."""
    return disparity_from_volume(aggregated_volume(left, right, cfg), left, cfg)


def disparity_from_volume(
    vol: np.ndarray, left: np.ndarray, cfg: StereoConfig
) -> np.ndarray:
    """WTA + subpixel + LR/uniqueness gates + fill + median from an
    aggregated volume (``left`` guides the weighted median)."""
    disp_i = wta(vol)
    disp = subpixel(vol, disp_i) if cfg.subpixel else disp_i.astype(np.float32)
    valid = None
    if cfg.lr_check:
        vol_r = right_volume(vol)
        disp_r_i = wta(vol_r)
        valid = lr_check(disp_i.astype(np.float32), disp_r_i.astype(np.float32), cfg)
    if cfg.uniqueness_ratio > 0:
        # WTA-uniqueness gate (5-loop literal form): accept iff the best
        # cost wins the minimum over d outside [best-1, best+1] by
        # uniqueness_ratio percent (cv2.StereoBM semantics).
        h, w, D = vol.shape
        uvalid = np.zeros((h, w), bool)
        for y in range(h):
            for x in range(w):
                b = int(disp_i[y, x])
                second = np.inf
                for d in range(D):
                    if abs(d - b) > 1 and vol[y, x, d] < second:
                        second = vol[y, x, d]
                uvalid[y, x] = (
                    second * 100.0
                    >= vol[y, x, b] * (100.0 + cfg.uniqueness_ratio)
                )
        valid = uvalid if valid is None else valid & uvalid
    if valid is not None:
        if cfg.fill_holes:
            disp = fill_holes(disp, valid)
        else:
            disp = np.where(valid, disp, -1.0).astype(np.float32)
    if cfg.median_filter:
        if cfg.median_mode == "weighted":
            disp = weighted_median3(disp, left, cfg)
        else:
            disp = median3(disp)
    return disp.astype(np.float32)
