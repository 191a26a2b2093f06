"""Winner-take-all disparity selection + subpixel refinement (L4/L5).

Per the pinned spec (config.py): first-occurrence argmin over d; parabola
subpixel ``d* = d - (C+ - C-) / (2 (C+ - 2 C0 + C-))`` with the offset clamped
to [-0.5, 0.5], applied only for 0 < d < D-1 and |denom| > 1e-6.
"""

from __future__ import annotations

import jax.numpy as jnp


def wta(vol: jnp.ndarray) -> jnp.ndarray:
    """(H, W, D) -> int32 (H, W) argmin (first minimum wins, like np.argmin)."""
    return jnp.argmin(vol, axis=-1).astype(jnp.int32)


def wta_with_triple(vol: jnp.ndarray) -> dict:
    """Argmin plus the (C[d*-1], C[d*], C[d*+1]) parabola triple.

    cm/cp at the d-range edges are clamped reads (masked later by the
    subpixel guard).
    """
    D = vol.shape[-1]
    d = jnp.argmin(vol, axis=-1).astype(jnp.int32)
    take = lambda i: jnp.take_along_axis(vol, i[..., None], axis=-1)[..., 0]
    return {
        "bestd": d,
        "bestc": take(d),
        "cm": take(jnp.clip(d - 1, 0, D - 1)),
        "cp": take(jnp.clip(d + 1, 0, D - 1)),
    }


def subpixel(vol: jnp.ndarray, disp: jnp.ndarray) -> jnp.ndarray:
    """Parabola refinement around the integer winner.  vol: (H, W, D)."""
    D = vol.shape[-1]
    d = disp.astype(jnp.int32)
    dm = jnp.clip(d - 1, 0, D - 1)
    dp = jnp.clip(d + 1, 0, D - 1)
    take = lambda idx: jnp.take_along_axis(vol, idx[..., None], axis=-1)[..., 0]
    c0, cm, cp = take(d), take(dm), take(dp)
    denom = cp - 2.0 * c0 + cm
    off = (cp - cm) / (2.0 * denom)
    off = jnp.clip(off, -0.5, 0.5)
    ok = (d > 0) & (d < D - 1) & (jnp.abs(denom) > 1e-6)
    return jnp.where(ok, d.astype(jnp.float32) - off, d.astype(jnp.float32))


def subpixel_from_triple(
    disp: jnp.ndarray,
    c0: jnp.ndarray,
    cm: jnp.ndarray,
    cp: jnp.ndarray,
    max_disparity: int,
) -> jnp.ndarray:
    """Parabola refinement from a (C[d-1], C[d], C[d+1]) winner triple (the
    form the sharded layouts combine) — same formula and guards as
    ``subpixel``."""
    d = disp.astype(jnp.int32)
    denom = cp - 2.0 * c0 + cm
    off = jnp.clip((cp - cm) / (2.0 * denom), -0.5, 0.5)
    ok = (d > 0) & (d < max_disparity - 1) & (jnp.abs(denom) > 1e-6)
    return jnp.where(ok, d.astype(jnp.float32) - off, d.astype(jnp.float32))


def second_best_excl_neighbors(vol: jnp.ndarray, disp: jnp.ndarray) -> jnp.ndarray:
    """Second-best aggregated cost excluding d within +-1 of the winner.

    The uniqueness-confidence operand (the knob cv2.StereoBM/SGBM ship as
    ``uniquenessRatio``): vol (H, W, D), disp the integer WTA argmin.
    Returns (H, W); +inf where every candidate lies within the excluded
    window (D <= 3) — the gate then accepts.
    """
    d_idx = jnp.arange(vol.shape[-1])
    far = jnp.abs(d_idx[None, None, :] - disp[..., None]) > 1
    return jnp.min(jnp.where(far, vol, jnp.inf), axis=-1)


def uniqueness_valid(
    best: jnp.ndarray, second: jnp.ndarray, ratio: float
) -> jnp.ndarray:
    """cv2-style uniqueness gate: accept iff the best cost wins the far
    second-best by ``ratio`` percent — ``second*100 >= best*(100+ratio)``.

    Costs are non-negative (truncated ADs); an unbounded ``second`` (no far
    candidate) always accepts.
    """
    return second * 100.0 >= best * (100.0 + ratio)
