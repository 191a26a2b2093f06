"""Color-space conversions, single source of truth for NumPy and JAX.

The ASW weights (Yoon-Kweon TPAMI 2006 section 3) are defined over CIELab
color differences; the reference's preprocess layer (SURVEY.md section 1, L1)
uses OpenCV's cvtColor.  To avoid a dual-maintenance parity hazard between the
NumPy oracle and the JAX/Pallas pipeline, every conversion here is written
once, parameterized by the array namespace ``xp`` (``numpy`` or ``jax.numpy``).

Backend determinism: transcendental ``pow`` differs by ~1e-3 relative between
NumPy and XLA in f32, which is enough to flip near-tie WTA winners.  The Lab
conversion therefore avoids ``pow`` entirely:
  - sRGB gamma decode is a 256-entry float64-precomputed LUT — inputs are
    pinned to 8-bit-integral RGB values (the reference operates on 8-bit
    images; arbitrary floats are rounded to the 8-bit grid);
  - the CIE cube root uses an exponent-bit-hack seed + 4 Newton iterations,
    i.e. only IEEE mul/add/div, identical across NumPy / XLA CPU / GPU to
    ~1 ulp.

Pinned conventions (see config.py):
  - input RGB is float32 in [0, 255] on the 8-bit integer grid
  - grayscale is Rec.601 (matches cv2 RGB2GRAY)
  - Lab is CIE L*a*b* with D65 white and sRGB gamma; L in [0, 100]
"""

from __future__ import annotations

import numpy as np

# D65 reference white (2 degree observer), sRGB primaries.
_SRGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_WHITE_D65 = np.array([0.950456, 1.0, 1.088754], dtype=np.float32)


def _make_srgb_lut() -> np.ndarray:
    """256-entry sRGB electro-optical transfer LUT, computed in float64."""
    c = np.arange(256, dtype=np.float64) / 255.0
    lin = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    return lin.astype(np.float32)


SRGB_DECODE_LUT = _make_srgb_lut()


def rgb_to_gray(rgb, xp):
    """Rec.601 luma on [0,255] RGB -> [0,255] gray.  rgb: (..., 3)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return (0.299 * r + 0.587 * g + 0.114 * b).astype(xp.float32)


def cbrt_newton(t, xp):
    """Cube root for t >= 0 via exponent-bit seed + 4 Newton steps.

    Uses only bitcasts and IEEE mul/add/div so NumPy and XLA (CPU, GPU)
    agree to ~1 ulp.  (Classic float hack: bits/3 + magic approximates cbrt to ~5%.)
    """
    t = t.astype(xp.float32)
    bits = t.view(np.int32) if xp is np else None
    if xp is np:
        seed_bits = bits // 3 + np.int32(0x2A514067)
        y = seed_bits.view(np.float32)
    else:
        import jax.lax as lax

        bits = lax.bitcast_convert_type(t, xp.int32)
        seed_bits = bits // 3 + xp.int32(0x2A514067)
        y = lax.bitcast_convert_type(seed_bits, xp.float32)
    for _ in range(4):
        y = (2.0 * y + t / (y * y)) * xp.float32(1.0 / 3.0)
        y = y.astype(xp.float32)
    # Exact at t == 0 (seed path would give garbage only for t < 0).
    return xp.where(t > 0, y, xp.float32(0.0)).astype(xp.float32)


def _lab_f(t, xp):
    """CIE Lab forward nonlinearity: cbrt above (6/29)^3, linear below."""
    delta = 6.0 / 29.0
    cube = np.float32(delta**3)
    lin = t / np.float32(3.0 * delta**2) + np.float32(4.0 / 29.0)
    return xp.where(t > cube, cbrt_newton(t, xp), lin.astype(xp.float32))


def srgb_decode(rgb255, xp):
    """[0,255] 8-bit-grid RGB -> linear RGB in [0,1] via the pinned LUT
    (a plain gather in both namespaces)."""
    idx = xp.clip(xp.round(rgb255), 0, 255).astype(xp.int32)
    return xp.asarray(SRGB_DECODE_LUT)[idx]


def rgb_to_lab(rgb, xp):
    """RGB [0,255] (..., 3) -> CIELab (L in [0,100]).

    Matrix products are written as explicit mul/adds (not matmul) so the
    f32 accumulation order is pinned across backends.
    """
    lin = srgb_decode(rgb, xp)
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    m = _SRGB_TO_XYZ
    wt = _WHITE_D65
    x = (r * m[0, 0] + g * m[0, 1] + b * m[0, 2]) * np.float32(1.0 / wt[0])
    y = r * m[1, 0] + g * m[1, 1] + b * m[1, 2]
    z = (r * m[2, 0] + g * m[2, 1] + b * m[2, 2]) * np.float32(1.0 / wt[2])
    fx = _lab_f(x.astype(xp.float32), xp)
    fy = _lab_f(y.astype(xp.float32), xp)
    fz = _lab_f(z.astype(xp.float32), xp)
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    bb = 200.0 * (fy - fz)
    return xp.stack([L, a, bb], axis=-1).astype(xp.float32)
