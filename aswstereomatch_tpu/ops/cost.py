"""Cost-volume construction (SURVEY.md section 1, L2) in JAX.

Per the pinned spec (config.py, virtual padded-plane semantics):
  AD:        C(x, d) = mean_c |Lp_c(x) - Rp_c(x - d)|
  TAD+grad:  C = alpha * min(AD, tau1) + (1-alpha) * min(|gLp - gRp(x-d)|, tau2)
defined on the x-extended domain x in [-rx, W-1+rx] that aggregation taps,
where Lp/Rp are the edge-padded virtual planes (Rp by rx + D - 1 on the left).

Entry points:
  - ``precompute(left, right, cfg, x_extend)``: padded color/gradient planes.
  - ``cost_plane(..., d)``: one (H, W + 2*x_extend) slice for a single d —
    used by fused scans so the H*W*D volume never exists (SURVEY section 6).
  - ``cost_volume(left, right, cfg, x_extend=0)``: materialized volume.

All accesses are static/dynamic *slices* of the padded planes — no gathers —
so XLA lowers everything to fused elementwise code, and any tiled layout
shares the exact semantics with pure shifts.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ..config import StereoConfig
from . import preprocess


class CostPlanes(NamedTuple):
    lc: jnp.ndarray   # (H, W + 2*rx, C) left color, edge-padded by rx
    rc: jnp.ndarray   # (H, W + 2*rx + D - 1, C) right color, padded rx+D-1 / rx
    gl: jnp.ndarray   # (H, W + 2*rx) left x-gradient, same padding as lc
    gr: jnp.ndarray   # like rc for the right x-gradient
    x_extend: int


def _pad_x(arr: jnp.ndarray, left: int, right: int) -> jnp.ndarray:
    widths = [(0, 0), (left, right)] + [(0, 0)] * (arr.ndim - 2)
    return jnp.pad(arr, widths, mode="edge")


def _as_chw(img: jnp.ndarray) -> jnp.ndarray:
    if img.ndim == 2:
        img = img[..., None]
    return img.astype(jnp.float32)


def precompute(
    left: jnp.ndarray, right: jnp.ndarray, cfg: StereoConfig, x_extend: int = 0
) -> CostPlanes:
    """Edge-padded per-pair planes shared across disparities."""
    D = cfg.max_disparity
    lc = _pad_x(_as_chw(left), x_extend, x_extend)
    rc = _pad_x(_as_chw(right), x_extend + D - 1, x_extend)
    gl = _pad_x(preprocess.x_gradient(preprocess.rgb_to_gray(left)), x_extend, x_extend)
    gr = _pad_x(
        preprocess.x_gradient(preprocess.rgb_to_gray(right)), x_extend + D - 1, x_extend
    )
    return CostPlanes(lc, rc, gl, gr, x_extend)


def planes_from_stacks(
    l_stack: jnp.ndarray, r_stack: jnp.ndarray, x_extend: int
) -> CostPlanes:
    """CostPlanes from pre-extended channel stacks (x-tiling path).

    Stacks are (7, H, W') in preprocess.channel_stack layout — channels were
    computed *globally* (the x-gradient is the only non-pointwise one), then
    column halos were exchanged, so the extended columns hold real neighbor
    data and boundary shards hold edge replicas == the virtual padded plane.
    l_stack covers the cost domain [-x_extend, W-1+x_extend]; r_stack has
    D-1 additional left columns.
    """
    def chw(stack):
        return jnp.moveaxis(stack[0:3], 0, -1)

    return CostPlanes(
        chw(l_stack), chw(r_stack), l_stack[3], r_stack[3], x_extend
    )


def cost_plane(planes: CostPlanes, d, cfg: StereoConfig) -> jnp.ndarray:
    """(H, W + 2*x_extend) raw cost for disparity d (python int or traced)."""
    D = cfg.max_disparity
    h, we = planes.gl.shape
    start = (D - 1) - d
    rs = lax.dynamic_slice(
        planes.rc, (0, start, 0), (h, we, planes.rc.shape[2])
    )
    ad = jnp.abs(planes.lc - rs).mean(axis=-1)
    if cfg.cost == "ad":
        return ad.astype(jnp.float32)
    gs = lax.dynamic_slice(planes.gr, (0, start), (h, we))
    out = cfg.alpha * jnp.minimum(ad, cfg.tau_color) + (1.0 - cfg.alpha) * jnp.minimum(
        jnp.abs(planes.gl - gs), cfg.tau_grad
    )
    return out.astype(jnp.float32)


def cost_volume(
    left: jnp.ndarray, right: jnp.ndarray, cfg: StereoConfig, x_extend: int = 0
) -> jnp.ndarray:
    """Materialized (H, W + 2*x_extend, D) raw cost volume."""
    planes = precompute(left, right, cfg, x_extend)

    def step(_, d):
        return None, cost_plane(planes, d, cfg)

    _, out = lax.scan(step, None, jnp.arange(cfg.max_disparity))
    return jnp.moveaxis(out, 0, -1)
