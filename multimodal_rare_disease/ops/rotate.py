"""Gather-free batched image rotation (Paeth three-shear decomposition).

Per-element gathers are a slow way to resample a whole batch, so
rotation is decomposed into three shear passes —
R(θ) = Sx(-tan θ/2) ∘ Sy(sin θ) ∘ Sx(-tan θ/2) — and each
shear is evaluated as a sum over STATIC lane/sublane shifts weighted by
per-row (or per-column) tent weights:

    out[h, j] = Σ_k  tent(δ(h) - k) · in[h, j - k]

Static shifts are pure pads+slices (vectorized, fusable); the k-range is
bounded by the max rotation angle, so the whole rotation is
O(K · B·S·S·C) fused FMAs with zero gathers. Zero fill at borders
(torchvision RandomRotation parity).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _shear(x: jnp.ndarray, factor: jnp.ndarray, axis: str,
           max_abs_factor: float) -> jnp.ndarray:
    """Shear pass: along x, out[h,j] = in[h, j - factor*(h-c)];
    along y, out[h,j] = in[h - factor*(j-c), j]. `factor` is per-image.

    Formulation note: the input is zero-padded ONCE along the sheared
    axis and every static shift is a pure slice of that one buffer —
    XLA fuses the whole Σ_k w_k·slice_k accumulation into a single
    elementwise pass. A concat-per-shift formulation would materialize
    a full tensor per k (111 passes per rotation) and compile slowly;
    this one is a single fused read."""
    B, H, W, C = x.shape
    if axis == "x":
        coord = jnp.arange(H, dtype=jnp.float32) - (H - 1) / 2.0  # rows
        half = (H - 1) / 2.0
    else:
        coord = jnp.arange(W, dtype=jnp.float32) - (W - 1) / 2.0  # cols
        half = (W - 1) / 2.0

    delta = factor[:, None] * coord[None, :]  # [B, H or W]
    K = int(math.ceil(max_abs_factor * half)) + 1

    if axis == "x":
        padded = jnp.pad(x, ((0, 0), (0, 0), (K, K), (0, 0)))
    else:
        padded = jnp.pad(x, ((0, 0), (K, K), (0, 0), (0, 0)))

    acc = jnp.zeros_like(x)
    for k in range(-K, K + 1):
        w = jnp.clip(1.0 - jnp.abs(delta - k), 0.0, 1.0)  # [B, H|W]
        if axis == "x":
            # out[..., j] += w[h] * in[..., j - k]  (slice of the pad)
            shifted = jax.lax.slice_in_dim(padded, K - k, K - k + W, axis=2)
            acc = acc + w[:, :, None, None] * shifted
        else:
            shifted = jax.lax.slice_in_dim(padded, K - k, K - k + H, axis=1)
            acc = acc + w[:, None, :, None] * shifted
    return acc


def rotate_batch(images: jnp.ndarray, angles: jnp.ndarray,
                 max_degrees: float = 15.0) -> jnp.ndarray:
    """Rotate [B,H,W,C] float images by per-image `angles` (radians),
    |angle| <= max_degrees, about the center, zero-filled corners."""
    max_rad = math.radians(max_degrees)
    a = -jnp.tan(angles / 2.0)
    b = jnp.sin(angles)
    max_a = abs(math.tan(max_rad / 2.0))
    max_b = abs(math.sin(max_rad))
    x = _shear(images, a, "x", max_a)
    x = _shear(x, b, "y", max_b)
    x = _shear(x, a, "x", max_a)
    return x
