"""Preprocess stage (SURVEY.md section 1, L1) in JAX.

Grayscale + x-gradient + CIELab conversion, all static-shape, fusible jnp —
the JAX replacement for the reference's cv::cvtColor / cv::Sobel calls.
Conversions come from utils.colorspace (single source shared with the NumPy
oracle).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils import colorspace


def rgb_to_gray(img: jnp.ndarray) -> jnp.ndarray:
    if img.ndim == 2:
        return img.astype(jnp.float32)
    return colorspace.rgb_to_gray(img, jnp)


def rgb_to_lab(img: jnp.ndarray) -> jnp.ndarray:
    if img.ndim == 2:
        img = jnp.stack([img] * 3, axis=-1)
    return colorspace.rgb_to_lab(img, jnp)


def x_gradient(gray: jnp.ndarray) -> jnp.ndarray:
    """Central difference g(x) = I(x+1) - I(x-1), replicate border.

    Matches cv2.Sobel(ksize=1, dx=1) with BORDER_REPLICATE and the oracle's
    loop form exactly.
    """
    pad = jnp.pad(gray, ((0, 0), (1, 1)), mode="edge")
    return (pad[:, 2:] - pad[:, :-2]).astype(jnp.float32)


def channel_stack(img: jnp.ndarray) -> jnp.ndarray:
    """(H, W[,3]) image -> (7, H, W): RGB, x-gradient, Lab.

    The per-pair plane bundle every downstream stage consumes (cost: RGB +
    gradient; ASW weights: Lab).  All channels are pointwise except the
    gradient, so computing the stack *globally* and then slicing/halo-
    exchanging columns is exact — the basis of the x-tiling path and the
    Pallas patch extraction.
    """
    if img.ndim == 2:
        rgb = jnp.stack([img] * 3, axis=0).astype(jnp.float32)
    else:
        rgb = jnp.moveaxis(img.astype(jnp.float32), -1, 0)
    gray = rgb_to_gray(img)
    grad = x_gradient(gray)[None]
    lab = jnp.moveaxis(rgb_to_lab(img), -1, 0)
    return jnp.concatenate([rgb, grad, lab], axis=0)
