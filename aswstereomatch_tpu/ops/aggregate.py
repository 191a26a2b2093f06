"""Cost aggregation (SURVEY.md section 1, L3) in JAX.

Two aggregators, per the reference's capability set (SURVEY.md section 2.1),
both under the pinned virtual padded-plane border semantics (config.py):

  - ``aggregate_box``: fixed-window mean (the BASELINE config-1 path) —
    x taps slide VALID over the x-extended cost, y taps over edge-replicated
    rows, via ``lax.reduce_window``.

  - ``aggregate_asw``: Yoon-Kweon adaptive-support-weight bilateral
    aggregation (TPAMI 2006 section 3) with symmetric two-view weights — the
    algorithm the reference repo exists for (SURVEY.md section 3.2).  The
    structure exploits the two key facts from the survey: weights depend on
    the *images*, not the cost, so the left-weight planes are computed once
    and reused across all d; and the right weights are the same planes on the
    x-extended right domain, indexed at x - d — a pure dynamic slice inside a
    ``lax.scan`` over disparities.  Raw cost is computed per-plane inside the
    scan, so no unaggregated H*W*D volume is materialized.

This is the production implementation, compiled by XLA: it materializes the
(H, W, K^2) weight planes and the aggregated output volume in device memory.
A fused kernel that keeps the per-d products on chip must reproduce these
semantics (the NumPy oracle pins them).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..config import StereoConfig
from . import cost as cost_ops
from . import preprocess


def _patches_2d(arr: jnp.ndarray, radius: int, x_valid: bool = False) -> jnp.ndarray:
    """All (2r+1)^2 window taps of a 2D array.

    y: edge-replicate padding.  x: edge-replicate padding, or — when
    ``x_valid`` — the array is already x-extended by ``radius`` per side and
    taps slide VALID (output width = arr width - 2*radius).

    Returns (H, W_out, O) with offsets in row-major (wy, wx) order, matching
    the NumPy oracle's window loops.  Explicit static slices, NOT
    conv_general_dilated_patches: the conv lowering computes in reduced
    precision on some backends, which breaks bit-parity with the oracle.
    """
    k = 2 * radius + 1
    h, w_in = arr.shape
    if x_valid:
        pad = jnp.pad(arr, ((radius, radius), (0, 0)), mode="edge")
        w_out = w_in - 2 * radius
    else:
        pad = jnp.pad(arr, ((radius, radius), (radius, radius)), mode="edge")
        w_out = w_in
    taps = [
        pad[wy : wy + h, wx : wx + w_out] for wy in range(k) for wx in range(k)
    ]
    return jnp.stack(taps, axis=-1)  # (H, W_out, O)


def _spatial_weights(cfg: StereoConfig) -> np.ndarray:
    r = cfg.window_radius
    wy, wx = np.mgrid[-r : r + 1, -r : r + 1]
    dist = np.sqrt((wy**2 + wx**2).astype(np.float64))
    return np.exp(-dist / cfg.gamma_spatial).astype(np.float32).reshape(-1)


def bilateral_planes_from_lab(lab_ext: jnp.ndarray, cfg: StereoConfig) -> jnp.ndarray:
    """Per-center ASW weight planes w(p, p+o) from a pre-extended Lab image.

    lab_ext: (H, We + 2r, 3) covering [centers - r, centers + r]; extended
    columns may be real neighbor data (x-tiling) or edge replicas (the
    virtual padded plane) — identical math either way.  Returns (H, We, O).
    """
    r = cfg.window_radius
    we = lab_ext.shape[-2]
    d2 = None
    for c in range(3):
        p = _patches_2d(lab_ext[..., c], r, x_valid=True)
        diff = p - lab_ext[..., r : we - r, c : c + 1]  # ([r:-r] breaks at r=0)
        d2 = diff * diff if d2 is None else d2 + diff * diff
    dcolor = jnp.sqrt(d2)
    sw = jnp.asarray(_spatial_weights(cfg))
    return (jnp.exp(-dcolor / cfg.gamma_color) * sw).astype(jnp.float32)


def _bilateral_planes(
    img: jnp.ndarray, cfg: StereoConfig, x_pad_left: int = 0, x_pad_right: int = 0
) -> jnp.ndarray:
    """Weight planes for centers on [-x_pad_left, W-1+x_pad_right], taps on
    the edge-padded virtual plane.  Returns (H, W + xl + xr, O)."""
    r = cfg.window_radius
    imgp = cost_ops._pad_x(img, x_pad_left + r, x_pad_right + r)
    return bilateral_planes_from_lab(preprocess.rgb_to_lab(imgp), cfg)


def _patches_1d_y(arr: jnp.ndarray, radius: int) -> jnp.ndarray:
    """(H, W) -> (H, W, K) vertical window taps, edge-replicated in y."""
    k = 2 * radius + 1
    h = arr.shape[0]
    pad = jnp.pad(arr, ((radius, radius), (0, 0)), mode="edge")
    return jnp.stack([pad[o : o + h, :] for o in range(k)], axis=-1)


def _patches_1d_x(arr: jnp.ndarray, radius: int) -> jnp.ndarray:
    """x-extended (H, W + 2r) -> (H, W, K) horizontal taps, VALID slide."""
    k = 2 * radius + 1
    w_out = arr.shape[1] - 2 * radius
    return jnp.stack([arr[:, o : o + w_out] for o in range(k)], axis=-1)


def _axial_weights_np(cfg: StereoConfig) -> np.ndarray:
    r = cfg.window_radius
    o = np.abs(np.arange(-r, r + 1)).astype(np.float64)
    return np.exp(-o / cfg.gamma_spatial).astype(np.float32)


def _bilateral_1d(
    lab: jnp.ndarray, cfg: StereoConfig, axis: str, x_valid: bool = False
) -> jnp.ndarray:
    """1D bilateral weight planes w(p, p + o*e_axis) -> (H, W_out, K).

    axis "y": taps run down the column (edge-replicated rows).  axis "x"
    with x_valid: lab is pre-extended by r per side and taps slide VALID.
    Spatial factor is exp(-|o| / gamma_p) — the separable (L1) form.
    """
    r = cfg.window_radius
    patches = _patches_1d_y if axis == "y" else _patches_1d_x
    d2 = None
    if axis == "x":
        assert x_valid, "x-axis weights require a pre-extended lab plane"
        center = lab[..., r : lab.shape[-2] - r, :]
    else:
        center = lab
    for c in range(3):
        p = patches(lab[..., c], r)
        diff = p - center[..., c : c + 1]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    aw = jnp.asarray(_axial_weights_np(cfg))
    return (jnp.exp(-jnp.sqrt(d2) / cfg.gamma_color) * aw).astype(jnp.float32)


def aggregate_asw_separable_from_stacks(
    l_stack_ext: jnp.ndarray,
    r_stack_ext: jnp.ndarray,
    cfg: StereoConfig,
    d_indices: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Two-pass separable ASW from pre-extended channel stacks.

    The documented speed-mode APPROXIMATION of Yoon-Kweon (config
    ``asw_separable``): a vertical bilateral pass over the x-extended cost
    plane followed by a horizontal bilateral pass, O(2K) taps per (pixel, d)
    instead of O(K^2).  The effective window weight becomes

        w(p, p + (dy, dx)) = wh(p, p + dx*e_x) * wv(p + dx*e_x, +dy*e_y)

    (color path through the window cross, spatial exp(-(|dy|+|dx|)/gamma_p))
    — the standard real-time two-pass bilateral form.  Symmetric mode
    multiplies the matching right-view factor into BOTH passes, preserving
    the view symmetry that makes LR-check volume reuse exact.  Same virtual
    padded-plane border semantics and stack layout as
    ``aggregate_asw_from_stacks``; x-tiling/d-sharding route through here
    unchanged, so tiled == untiled stays bit-exact.
    """
    r = cfg.window_radius
    D = cfg.max_disparity
    h = l_stack_ext.shape[1]
    we = l_stack_ext.shape[2]          # W + 2r
    w = we - 2 * r
    K = 2 * r + 1

    planes = cost_ops.planes_from_stacks(l_stack_ext, r_stack_ext, r)
    lab_l = jnp.moveaxis(l_stack_ext[4:7], 0, -1)          # (H, W + 2r, 3)
    # Vertical weights for every column the horizontal pass can tap.
    wvl = _bilateral_1d(lab_l, cfg, "y")                   # (H, W + 2r, K)
    # Horizontal weights need taps r beyond the centers: re-extend by edge
    # replication (identical to the virtual plane's columns there).
    lab_l2 = jnp.pad(lab_l, ((0, 0), (r, r), (0, 0)), mode="edge")
    whl = _bilateral_1d(lab_l2, cfg, "x", x_valid=True)    # (H, W + 2r, K)
    if cfg.asw_symmetric:
        lab_r = jnp.moveaxis(r_stack_ext[4:7], 0, -1)      # (H, W+2r+D-1, 3)
        wvr = _bilateral_1d(lab_r, cfg, "y")               # (H, W+2r+D-1, K)
        lab_r2 = jnp.pad(lab_r, ((0, 0), (r, r), (0, 0)), mode="edge")
        whr = _bilateral_1d(lab_r2, cfg, "x", x_valid=True)
    else:
        wvr = whr = None

    def step(_, d):
        plane = cost_ops.cost_plane(planes, d, cfg)        # (H, W + 2r)
        wv = wvl
        if wvr is not None:
            wv = wv * lax.dynamic_slice(wvr, (0, (D - 1) - d, 0), (h, we, K))
        ytaps = _patches_1d_y(plane, r)                    # (H, W + 2r, K)
        numv = jnp.sum(wv * ytaps, axis=-1)                # (H, W + 2r)
        denv = jnp.sum(wv, axis=-1)
        wh = whl
        if whr is not None:
            wh = wh * lax.dynamic_slice(whr, (0, (D - 1) - d, 0), (h, we, K))
        # Horizontal centers live on the x-extended domain too (width
        # W + 2r) so the result matches the non-separable output width the
        # callers slice/consume... but downstream expects (H, W): aggregate
        # only the true centers.
        wh_c = wh[:, r : we - r, :]                        # (H, W, K)
        num = jnp.sum(wh_c * _patches_1d_x(numv, r), axis=-1)
        den = jnp.sum(wh_c * _patches_1d_x(denv, r), axis=-1)
        return None, (num / den).astype(jnp.float32)

    if d_indices is None:
        d_indices = jnp.arange(D)
    _, out = lax.scan(step, None, d_indices)
    return jnp.moveaxis(out, 0, -1)                        # (H, W, len(d))


def aggregate_box(vol_ext: jnp.ndarray, cfg: StereoConfig) -> jnp.ndarray:
    """Mean over the (2r+1)^2 window.  vol_ext: x-extended (H, W+2r, D)."""
    r = cfg.window_radius
    if r == 0:
        return vol_ext
    k = 2 * r + 1
    pad = jnp.pad(vol_ext, ((r, r), (0, 0), (0, 0)), mode="edge")
    summed = lax.reduce_window(pad, 0.0, lax.add, (k, k, 1), (1, 1, 1), "VALID")
    return (summed / float(k * k)).astype(jnp.float32)


def cost_volume_from_stacks(
    l_stack_ext: jnp.ndarray,
    r_stack_ext: jnp.ndarray,
    cfg: StereoConfig,
) -> jnp.ndarray:
    """x-extended raw cost volume (H, W + 2r, D) from pre-extended stacks —
    the box-aggregation input for the x-tiled path."""
    r = cfg.window_radius
    planes = cost_ops.planes_from_stacks(l_stack_ext, r_stack_ext, r)

    def step(_, d):
        return None, cost_ops.cost_plane(planes, d, cfg)

    _, out = lax.scan(step, None, jnp.arange(cfg.max_disparity))
    return jnp.moveaxis(out, 0, -1)


def aggregate_asw_from_stacks(
    l_stack_ext: jnp.ndarray,
    r_stack_ext: jnp.ndarray,
    cfg: StereoConfig,
    d_indices: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """ASW-aggregated cost volume from pre-extended channel stacks.

    l_stack_ext: (7, H, W + 2r); r_stack_ext: (7, H, W + 2r + D - 1) —
    preprocess.channel_stack layout, columns extended per the pinned
    padded-plane semantics (edge replicas for a whole image; real neighbor
    columns for an x-tile — same math either way, which is exactly why the
    padded-plane spec was chosen).  Returns (H, W, len(d_indices)).
    """
    if cfg.asw_separable:
        return aggregate_asw_separable_from_stacks(
            l_stack_ext, r_stack_ext, cfg, d_indices
        )
    r = cfg.window_radius
    D = cfg.max_disparity
    h = l_stack_ext.shape[1]
    w = l_stack_ext.shape[2] - 2 * r

    planes = cost_ops.planes_from_stacks(l_stack_ext, r_stack_ext, r)
    lab_l = jnp.moveaxis(l_stack_ext[4:7], 0, -1)
    wl = bilateral_planes_from_lab(lab_l, cfg)  # (H, W, O)
    if cfg.asw_symmetric:
        # Right-weight planes on centers x' in [-(D-1), W-1]; step d slices
        # the window starting at (D-1) - d.
        lab_r = jnp.moveaxis(r_stack_ext[4:7], 0, -1)
        wr = bilateral_planes_from_lab(lab_r, cfg)  # (H, W + D - 1, O)
    else:
        wr = None
    O = wl.shape[-1]

    def step(_, d):
        plane = cost_ops.cost_plane(planes, d, cfg)  # (H, W + 2r)
        taps = _patches_2d(plane, r, x_valid=True)  # (H, W, O)
        if wr is not None:
            wr_d = lax.dynamic_slice(wr, (0, (D - 1) - d, 0), (h, w, O))
            wgt = wl * wr_d
        else:
            wgt = wl
        num = jnp.sum(wgt * taps, axis=-1)
        den = jnp.sum(wgt, axis=-1)
        return None, (num / den).astype(jnp.float32)

    if d_indices is None:
        d_indices = jnp.arange(D)
    _, out = lax.scan(step, None, d_indices)
    return jnp.moveaxis(out, 0, -1)  # (H, W, len(d_indices))


def aggregate_asw(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: StereoConfig,
    d_indices: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """ASW-aggregated cost volume for a full pair, fused cost construction.

    Edge-pads the channel stacks to the virtual padded planes and defers to
    ``aggregate_asw_from_stacks``.  Matches the oracle's
    aggregate_asw(cost_volume_ext(...)) composition.
    """
    r = cfg.window_radius
    D = cfg.max_disparity

    def pad(stack, pl_, pr_):
        return jnp.pad(stack, ((0, 0), (0, 0), (pl_, pr_)), mode="edge")

    ls = preprocess.channel_stack(left)
    rs = preprocess.channel_stack(right)
    return aggregate_asw_from_stacks(
        pad(ls, r, r), pad(rs, r + D - 1, r), cfg, d_indices
    )


# ---------------------------------------------------------------------------
# Semi-global aggregation (aggregation="sgm") — a beyond-reference extension
# (round 5; recurrence pinned in config.py).  The reference implements the
# LOCAL adaptive-support-weight method; the round-4 hard-regime measurement
# showed semi-global smoothness propagation is the stronger approach on
# ambiguous content at high coverage, so this closes that measured
# frontier.  Shape: each of the
# four path directions is one lax.scan along a spatial axis carrying a
# (lines, D) plane — per step a handful of vectorized (lines, D) mins/adds,
# which XLA fuses; no gathers, no data-dependent control flow.
# ---------------------------------------------------------------------------

def _sgm_scan(vol: jnp.ndarray, p1: float, p2: float) -> jnp.ndarray:
    """One directional pass along axis 0 of ``vol`` (N, M, D).

    Carries the previous step's (M, D) cost plane; the d+-1 neighbor terms
    are static pad-shifts (out-of-range -> +inf per the pinned spec).  The
    per-step vector work is tiny, so the pass is bound by per-step
    overhead; ``unroll=8`` amortizes the while-loop trip cost and is
    value-neutral (same op order per step).
    """
    p1 = jnp.float32(p1)
    p2 = jnp.float32(p2)
    inf = jnp.float32(jnp.inf)

    def step(prev, c):
        pmin = jnp.min(prev, axis=-1, keepdims=True)
        up = jnp.pad(prev[:, :-1], ((0, 0), (1, 0)), constant_values=inf)
        dn = jnp.pad(prev[:, 1:], ((0, 0), (0, 1)), constant_values=inf)
        best = jnp.minimum(
            jnp.minimum(prev, pmin + p2),
            jnp.minimum(up, dn) + p1,
        )
        out = c + best - pmin
        return out, out

    _, rest = lax.scan(step, vol[0], vol[1:], unroll=8)
    return jnp.concatenate([vol[:1], rest], axis=0)


def aggregate_sgm(vol: jnp.ndarray, cfg: StereoConfig) -> jnp.ndarray:
    """4-path semi-global aggregation of a raw (H, W, D) cost volume.

    S = L(left-to-right) + L(right-to-left) + L(top-down) + L(bottom-up),
    summed in that pinned order (models/oracle_numpy.py is the loop form).

    The two opposed directions of each axis are PACKED into one
    scan (a reversed copy concatenated along the carried-plane axis), so
    the whole aggregation is two sequential scans (W steps + H steps)
    instead of four — rows of the carried plane never interact in the
    step, so each packed half is bit-identical to its standalone pass.
    """
    p1, p2 = cfg.sgm_p1, cfg.sgm_p2
    h, w, D = vol.shape
    volx = jnp.swapaxes(vol, 0, 1)  # (W, H, D): scan along x
    sx = _sgm_scan(
        jnp.concatenate([volx, volx[::-1]], axis=1), p1, p2
    )  # (W, 2H, D): forward pass | reversed-x pass
    l2r = jnp.swapaxes(sx[:, :h], 0, 1)
    r2l = jnp.swapaxes(sx[::-1, h:], 0, 1)
    sy = _sgm_scan(
        jnp.concatenate([vol, vol[::-1]], axis=1), p1, p2
    )  # (H, 2W, D)
    t2b = sy[:, :w]
    b2t = sy[::-1, w:]
    s = ((l2r + r2l) + t2b) + b2t
    if cfg.sgm_paths == 8:
        # Diagonals, packed the same way: one top-down scan carries the
        # (1,1) and (1,-1) paths side by side (first half's predecessor
        # shifts +1 in x, second half's -1); its bottom-up mirror carries
        # (-1,1) and (-1,-1) (same shift structure on the reversed rows).
        dvol = jnp.concatenate([vol, vol], axis=1)
        dt = _sgm_scan_diag(dvol, p1, p2, w)
        db = _sgm_scan_diag(dvol[::-1], p1, p2, w)[::-1]
        s = (((s + dt[:, :w]) + dt[:, w:]) + db[:, :w]) + db[:, w:]
    return s.astype(jnp.float32)


def _sgm_scan_diag(vol2: jnp.ndarray, p1: float, p2: float, w: int) -> jnp.ndarray:
    """Packed diagonal pass along axis 0 of ``vol2`` (N, 2W, D).

    The carried plane's predecessor shifts one column per row step: +1 for
    the first W columns (the (dy, +1) path) and -1 for the last W (the
    (dy, -1) path).  Columns whose diagonal predecessor falls outside the
    image take L = C (the pinned first-pixel rule) — the inf-shifted
    column yields a non-finite pmin there, selected away with a where.
    """
    p1 = jnp.float32(p1)
    p2 = jnp.float32(p2)
    inf = jnp.float32(jnp.inf)

    def step(prev, c):
        a = jnp.pad(prev[:w][:-1], ((1, 0), (0, 0)), constant_values=inf)
        b = jnp.pad(prev[w:][1:], ((0, 1), (0, 0)), constant_values=inf)
        ps = jnp.concatenate([a, b], axis=0)
        pmin = jnp.min(ps, axis=-1, keepdims=True)
        up = jnp.pad(ps[:, :-1], ((0, 0), (1, 0)), constant_values=inf)
        dn = jnp.pad(ps[:, 1:], ((0, 0), (0, 1)), constant_values=inf)
        best = jnp.minimum(
            jnp.minimum(ps, pmin + p2),
            jnp.minimum(up, dn) + p1,
        )
        out = jnp.where(jnp.isfinite(pmin), c + best - pmin, c)
        return out, out

    _, rest = lax.scan(step, vol2[0], vol2[1:], unroll=8)
    return jnp.concatenate([vol2[:1], rest], axis=0)
