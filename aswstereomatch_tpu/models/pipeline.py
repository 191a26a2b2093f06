"""End-to-end stereo matching pipeline (SURVEY.md section 3.5 target shape).

``match_pair(left, right, cfg)`` is the jittable forward step on one pair:
images -> cost (fused into aggregation) -> WTA -> subpixel -> LR check ->
fill -> median -> float32 disparity map.  It composes the stage ops from
``aswstereomatch_tpu.ops`` and mirrors the NumPy oracle
(models/oracle_numpy.py) stage for stage.  Every stage is plain
``jax.numpy``/``lax`` compiled by XLA, in float32 throughout.

``StereoMatcher`` wraps a config with jitted single/batch/confidence entry
points — the "model" object of this framework; the BASELINE presets in
config.PRESETS are its model zoo.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax

from ..config import StereoConfig, get_preset
from ..ops import aggregate, cost, postprocess, wta


def aggregated_volume(
    left: jnp.ndarray, right: jnp.ndarray, cfg: StereoConfig
) -> jnp.ndarray:
    """(H, W, D) aggregated cost volume per the configured cost/aggregation."""
    if cfg.aggregation == "asw":
        return aggregate.aggregate_asw(left, right, cfg)
    if cfg.aggregation == "box":
        vol_ext = cost.cost_volume(left, right, cfg, x_extend=cfg.window_radius)
        return aggregate.aggregate_box(vol_ext, cfg)
    if cfg.aggregation == "sgm":
        return aggregate.aggregate_sgm(cost.cost_volume(left, right, cfg), cfg)
    return cost.cost_volume(left, right, cfg)


def disp_pre_from_winners(outs: dict, cfg: StereoConfig) -> jnp.ndarray:
    """Subpixel + LR/uniqueness gates + fill (row-local; no median) from the
    per-pixel WTA winners.

    ``outs`` holds (H, W) planes: ``bestd`` (int argmin), ``bestc``/``cm``/
    ``cp`` (the parabola triple C[d*], C[d*-1], C[d*+1]), ``rbestd`` (the
    right view's argmin, when ``cfg.lr_check``) and ``ubest`` (the far
    second-best cost, when ``cfg.uniqueness_ratio > 0``).  The unsharded
    path builds them from the whole volume (``winners_from_volume``); the
    x-tiled and d-sharded layouts assemble the same planes from per-shard
    partial winners, so every layout shares this one epilogue.
    """
    disp_i = outs["bestd"]
    if cfg.subpixel:
        disp = wta.subpixel_from_triple(
            disp_i, outs["bestc"], outs["cm"], outs["cp"], cfg.max_disparity
        )
    else:
        disp = disp_i.astype(jnp.float32)
    valid = None
    if cfg.lr_check:
        valid = postprocess.lr_check(
            disp_i.astype(jnp.float32), outs["rbestd"].astype(jnp.float32), cfg
        )
    if cfg.uniqueness_ratio > 0:
        uv = wta.uniqueness_valid(
            outs["bestc"], outs["ubest"], cfg.uniqueness_ratio
        )
        valid = uv if valid is None else valid & uv
    if valid is not None:
        if cfg.fill_holes:
            disp = postprocess.fill_holes(disp, valid)
        else:
            disp = jnp.where(valid, disp, -1.0).astype(jnp.float32)
    return disp.astype(jnp.float32)


def winners_from_volume(
    vol: jnp.ndarray, cfg: StereoConfig, always: bool = False
) -> dict:
    """The ``disp_pre_from_winners`` operands from a whole (H, W, D) volume.

    The right-view argmin and the far second-best are built only when the
    config consumes them, unless ``always`` (the confidence surface).
    """
    outs = wta.wta_with_triple(vol)
    if cfg.lr_check or always:
        outs["rbestd"] = wta.wta(postprocess.right_volume(vol))
    if cfg.uniqueness_ratio > 0 or always:
        outs["ubest"] = wta.second_best_excl_neighbors(vol, outs["bestd"])
    return outs


def disp_pre_from_volume(vol: jnp.ndarray, cfg: StereoConfig) -> jnp.ndarray:
    """WTA + subpixel + LR/uniqueness gates + fill (row-local; no median)."""
    return disp_pre_from_winners(winners_from_volume(vol, cfg), cfg)


def _guide_lab(left: jnp.ndarray, cfg: StereoConfig):
    if cfg.median_filter and cfg.median_mode == "weighted":
        from ..ops import preprocess

        return preprocess.rgb_to_lab(left)
    return None


def _postprocess_from_volume(
    vol: jnp.ndarray, cfg: StereoConfig, left: jnp.ndarray
) -> jnp.ndarray:
    """WTA + subpixel + LR + fill + median from an aggregated volume."""
    disp = disp_pre_from_volume(vol, cfg)
    if cfg.median_filter:
        disp = postprocess.median_filter(disp, cfg, _guide_lab(left, cfg))
    return disp


def tile_disparity(
    left_ext: jnp.ndarray,
    right_ext: jnp.ndarray,
    cfg: StereoConfig,
    halo: int,
    rows: int,
    true_h: int,
    start,
) -> jnp.ndarray:
    """Disparity for one row band given halo-extended image tiles.

    Shared by the shard_map tiled path (parallel/tiling.py, ``start`` is the
    traced ``axis_index * rows``) and the sequential chunked path below
    (``start`` is the chunk offset).  The band's final 3x3 median taps rows
    by *global-row-clamped* index so true-boundary rows reproduce the untiled
    edge clamp exactly — the tiled==untiled bit-exactness hinges on this.

    left_ext/right_ext: (halo + rows + halo, W[, 3]); returns (rows, W).
    """
    vol = aggregated_volume(left_ext, right_ext, cfg)
    disp = disp_pre_from_volume(vol, cfg)
    if not cfg.median_filter:
        return disp[halo : halo + rows]
    g = start - 1 + jnp.arange(rows + 2)  # global rows: owned +-1
    g = jnp.clip(g, 0, true_h - 1)
    local = jnp.clip(g - (start - halo), 0, disp.shape[0] - 1)
    med_in = jnp.take(disp, local, axis=0)  # (rows + 2, W)
    guide = _guide_lab(jnp.take(left_ext, local, axis=0), cfg)
    return postprocess.median_filter(med_in, cfg, guide)[1 : 1 + rows]


def match_pair_chunked(
    left: jnp.ndarray, right: jnp.ndarray, cfg: StereoConfig
) -> jnp.ndarray:
    """Single-device memory-streaming mode: process cfg.y_chunks row bands
    sequentially (lax.map), bounding peak HBM by ~1/y_chunks.

    Bit-identical to the unchunked pipeline (same machinery as the sharded
    tiles); it bounds the (H, W, w^2) exact-ASW weight planes when a frame's
    would otherwise exceed device memory.
    """
    if cfg.aggregation == "sgm":
        raise ValueError(
            "aggregation='sgm' propagates globally along scanlines; "
            "y_chunks row streaming cannot reproduce the unchunked result"
        )
    h, w = left.shape[:2]
    n = cfg.y_chunks
    halo = cfg.halo_y
    pad = (-h) % n
    widths = [(0, pad)] + [(0, 0)] * (left.ndim - 1)
    lp = jnp.pad(left, widths, mode="edge")
    rp = jnp.pad(right, widths, mode="edge")
    rows = lp.shape[0] // n
    if rows < halo:
        raise ValueError(f"{rows} rows/chunk < halo {halo}; reduce y_chunks")
    hw = [(halo, halo)] + [(0, 0)] * (left.ndim - 1)
    lp = jnp.pad(lp, hw, mode="edge")
    rp = jnp.pad(rp, hw, mode="edge")

    def chunk(i):
        start = i * rows
        l_ext = lax.dynamic_slice_in_dim(lp, start, rows + 2 * halo, axis=0)
        r_ext = lax.dynamic_slice_in_dim(rp, start, rows + 2 * halo, axis=0)
        return tile_disparity(l_ext, r_ext, cfg, halo, rows, h, start)

    bands = lax.map(chunk, jnp.arange(n))  # (n, rows, W)
    return bands.reshape(n * rows, w)[:h]


def match_pair(
    left: jnp.ndarray, right: jnp.ndarray, cfg: StereoConfig
) -> jnp.ndarray:
    """Match one rectified pair -> float32 (H, W) disparity.  Jit-friendly."""
    if cfg.y_chunks > 1:
        return match_pair_chunked(left, right, cfg)
    vol = aggregated_volume(left, right, cfg)
    return _postprocess_from_volume(vol, cfg, left)


def match_pair_with_confidence(
    left: jnp.ndarray, right: jnp.ndarray, cfg: StereoConfig
):
    """Match one pair and return per-pixel confidence operands.

    Returns ``(disp, uniq_pct, lr_valid)``:

      - ``disp``: the configured pipeline's disparity (all cfg gates
        applied, exactly as ``match_pair``);
      - ``uniq_pct``: the WTA-uniqueness margin ``(second/best - 1) * 100``
        where ``second`` is the best aggregated cost over d outside
        [best-1, best+1] — thresholding ``uniq_pct >= r`` reproduces the
        ``uniqueness_ratio=r`` gate without recompiling (agreement up to
        f32 division rounding on exact-knife-edge pixels; the in-graph
        gate's ``second*100 >= best*(100+r)`` form is canonical).  Clipped
        to [0, 1e6]; 1e6 where no far candidate exists;
      - ``lr_valid``: the LR-consistency mask (all True when
        ``cfg.lr_check`` is off).

    This is the selectable-coverage product surface: fetch once, choose
    the operating point downstream.  Jit-friendly.
    """
    if cfg.y_chunks > 1:
        # The chunked streamer returns only the disparity bands; the
        # confidence operands would need their own band plumbing.  Reject
        # rather than silently materializing the full volume a y_chunks
        # config exists to avoid.
        raise ValueError(
            "match_pair_with_confidence does not support y_chunks > 1; "
            "use y_chunks=1"
        )
    vol = aggregated_volume(left, right, cfg)
    outs = winners_from_volume(vol, cfg, always=True)
    disp = disp_pre_from_winners(outs, cfg)
    if cfg.median_filter:
        disp = postprocess.median_filter(disp, cfg, _guide_lab(left, cfg))
    bestc, second, disp_i = outs["bestc"], outs["ubest"], outs["bestd"]
    # Margin in the exact form the in-graph gate tests:
    # second*100 >= best*(100+r)  <=>  (second/best - 1)*100 >= r for
    # best > 0; at best == 0 the gate accepts for EVERY ratio (second >= 0
    # == best*(100+r)), so the margin is +inf there — a plain division
    # would clip to 0 and flip the decision on exact-zero-cost pixels.
    uniq_pct = jnp.where(
        bestc > 0.0,
        jnp.clip((second / jnp.where(bestc > 0.0, bestc, 1.0) - 1.0) * 100.0,
                 0.0, 1e6),
        jnp.float32(1e6),
    )
    if cfg.lr_check:
        lr_valid = postprocess.lr_check(
            disp_i.astype(jnp.float32), outs["rbestd"].astype(jnp.float32), cfg
        )
    else:
        lr_valid = jnp.ones(disp_i.shape, bool)
    return disp, uniq_pct, lr_valid


def match_batch(left: jnp.ndarray, right: jnp.ndarray, cfg: StereoConfig) -> jnp.ndarray:
    """Batched throughput mode: (B, H, W, 3) x2 -> (B, H, W), by vmap."""
    return jax.vmap(lambda l, r: match_pair(l, r, cfg))(left, right)


def _widened(fn, cfg: StereoConfig):
    """Jit ``fn(left, right, cfg)`` with a device-side float32 widen, so
    uint8 wire inputs (lossless for 8-bit images, 4x fewer host-to-device
    bytes) and float32 inputs share one entry point."""
    return jax.jit(
        lambda l, r: fn(l.astype(jnp.float32), r.astype(jnp.float32), cfg)
    )


class StereoMatcher:
    """A configured matcher with jitted entry points.

    >>> m = StereoMatcher.from_preset("middlebury_asw")
    >>> disp = m(left, right)                  # single pair
    >>> disps = m.batch(lefts, rights)         # batched
    >>> disp, uniq_pct, lr_valid = m.with_confidence(left, right)

    Inputs may be uint8 (widened to float32 on device, lossless) or
    float32; jit specializes per input shape/dtype.  Compiled programs land
    in JAX's persistent compilation cache when an entry point has enabled
    it (utils/compile_cache.py).  ``jit_pair``/``jit_batch``/
    ``jit_confidence`` are the unvalidated jitted entries, for callers that
    compile ahead of time (``.lower(l, r).compile()``).
    """

    def __init__(self, cfg: StereoConfig):
        self.cfg = cfg
        self.jit_pair = _widened(match_pair, cfg)
        self.jit_batch = _widened(match_batch, cfg)
        self.jit_confidence = _widened(match_pair_with_confidence, cfg)

    @classmethod
    def from_preset(cls, name: str, **overrides) -> "StereoMatcher":
        cfg = get_preset(name)
        if overrides:
            cfg = cfg.replace(**overrides)
        return cls(cfg)

    @staticmethod
    def _validate(left, right, batched: bool):
        want = 3 if batched else 2
        if left.ndim not in (want, want + 1):
            raise ValueError(
                f"expected {'(B, H, W[, 3])' if batched else '(H, W[, 3])'} "
                f"images, got shape {left.shape}"
            )
        if left.shape != right.shape:
            raise ValueError(
                f"left/right shape mismatch: {left.shape} vs {right.shape}"
            )

    def __call__(self, left, right):
        left, right = jnp.asarray(left), jnp.asarray(right)
        self._validate(left, right, batched=False)
        return self.jit_pair(left, right)

    def batch(self, lefts, rights):
        lefts, rights = jnp.asarray(lefts), jnp.asarray(rights)
        self._validate(lefts, rights, batched=True)
        return self.jit_batch(lefts, rights)

    def with_confidence(self, left, right):
        """``(disp, uniq_pct, lr_valid)`` — see match_pair_with_confidence."""
        left, right = jnp.asarray(left), jnp.asarray(right)
        self._validate(left, right, batched=False)
        return self.jit_confidence(left, right)
