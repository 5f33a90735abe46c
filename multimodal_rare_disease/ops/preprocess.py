"""On-device image preprocessing & augmentation.

On-device replacement for the reference's torchvision/PIL transform
stacks (`src/image_dataset_loader.py:80-140`, `src/train_multimodal.py:317-353`,
`src/enhanced_augmentation.py:28-66`): the host stops at decoded uint8
arrays; everything else — geometry, color jitter, normalization — runs
batched on device inside the jitted step, so preprocessing overlaps with
training and feeds the model without host round-trips.

Design:
- ALL geometric ops (random resized crop, rotation ±15°, horizontal flip,
  center crop/resize) compose into ONE affine matrix per image and execute
  as a single bilinear gather (`affine_resample`). One gather instead of
  three separate resamples is the main bandwidth win; the reference runs
  the equivalent chain as 3-4 separate PIL/torchvision passes per image
  on the host.
- Color jitter (brightness/contrast/saturation) + ImageNet normalization
  are elementwise, and XLA fuses them into one pass (for the predict path,
  the uint8→normalized cast+scale chain; see `eval_preprocess`).
- Everything is fixed-shape and fully vmapped: [B,256,256,3] uint8 →
  [B,224,224,3] float, per-image randomness from one folded PRNG key.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from multimodal_rare_disease.config import Config

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


# ---------------------------------------------------------------------------
# geometry: one fused affine resample
# ---------------------------------------------------------------------------

def _bilinear_sample(img: jnp.ndarray, ys: jnp.ndarray, xs: jnp.ndarray
                     ) -> jnp.ndarray:
    """Sample img [H,W,C] at float coords ys/xs [h,w] with edge clamping."""
    H, W = img.shape[0], img.shape[1]
    y0 = jnp.floor(ys)
    x0 = jnp.floor(xs)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 1)
    y1i = jnp.clip(y0i + 1, 0, H - 1)
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 1)
    x1i = jnp.clip(x0i + 1, 0, W - 1)
    p00 = img[y0i, x0i]
    p01 = img[y0i, x1i]
    p10 = img[y1i, x0i]
    p11 = img[y1i, x1i]
    top = p00 * (1 - wx) + p01 * wx
    bot = p10 * (1 - wx) + p11 * wx
    return top * (1 - wy) + bot * wy


def _single_affine(img: jnp.ndarray, matrix: jnp.ndarray, out_size: int
                   ) -> jnp.ndarray:
    """Apply a 2x3 output→input affine map to one [H,W,C] image."""
    ii = jnp.arange(out_size, dtype=jnp.float32)
    jj = jnp.arange(out_size, dtype=jnp.float32)
    gy, gx = jnp.meshgrid(ii, jj, indexing="ij")
    ys = matrix[0, 0] * gy + matrix[0, 1] * gx + matrix[0, 2]
    xs = matrix[1, 0] * gy + matrix[1, 1] * gx + matrix[1, 2]
    return _bilinear_sample(img, ys, xs)


def affine_resample(images: jnp.ndarray, matrices: jnp.ndarray, out_size: int
                    ) -> jnp.ndarray:
    """Batched affine warp: [B,H,W,C] × [B,2,3] → [B,out,out,C] float32.

    matrices map OUTPUT pixel coords (y,x) to INPUT coords.
    """
    images = images.astype(jnp.float32)
    return jax.vmap(partial(_single_affine, out_size=out_size))(images, matrices)


def _compose_affine(
    in_size: float,
    out_size: float,
    crop_scale: jnp.ndarray,     # scalar: fraction of input area to keep
    angle_rad: jnp.ndarray,      # scalar rotation
    flip: jnp.ndarray,           # scalar {0,1}
    shift_y: jnp.ndarray,        # [-1,1] crop-center offset within slack
    shift_x: jnp.ndarray,
) -> jnp.ndarray:
    """Build the 2x3 output→input matrix: rotate about crop center, scale
    crop→out, translate to a random crop window, optional horizontal flip."""
    crop_size = in_size * jnp.sqrt(crop_scale)
    scale = crop_size / out_size
    cos = jnp.cos(angle_rad) * scale
    sin = jnp.sin(angle_rad) * scale
    # flip x direction
    fx = jnp.where(flip > 0, -1.0, 1.0)
    # output center
    oc = (out_size - 1) / 2.0
    # crop center within the valid slack region
    slack = (in_size - crop_size) / 2.0
    cy = (in_size - 1) / 2.0 + shift_y * slack
    cx = (in_size - 1) / 2.0 + shift_x * slack
    # y_in = cos*(y-oc) - sin*fx*(x-oc) + cy ; x_in = sin*(y-oc) + cos*fx*(x-oc) + cx
    a00 = cos
    a01 = -sin * fx
    a10 = sin
    a11 = cos * fx
    t0 = cy - a00 * oc - a01 * oc
    t1 = cx - a10 * oc - a11 * oc
    return jnp.stack([jnp.stack([a00, a01, t0]), jnp.stack([a10, a11, t1])])


# ---------------------------------------------------------------------------
# geometry: separable bilinear resampling as batched matmuls
# ---------------------------------------------------------------------------

def _axis_weights(scale: jnp.ndarray, shift: jnp.ndarray, out_size: int,
                  in_size: int, filter_width: float = 1.0) -> jnp.ndarray:
    """Per-image 1-D bilinear interpolation matrices W [B, out, in]:
    source coordinate src(o) = scale*o + shift; W[b,o,i] = tent((src-i)/fw),
    rows renormalized → clamp-to-edge for out-of-range sources.

    filter_width > 1 widens the tent to PIL's antialiased triangle filter
    (fw = downscale factor), matching torchvision Resize semantics when
    downsampling."""
    fw = float(max(filter_width, 1.0))
    o = jnp.arange(out_size, dtype=jnp.float32)
    i = jnp.arange(in_size, dtype=jnp.float32)
    src = scale[:, None] * o[None, :] + shift[:, None]          # [B, out]
    d = jnp.abs(src[:, :, None] - i[None, None, :])             # [B, out, in]
    w = jnp.clip(1.0 - d / fw, 0.0, 1.0)
    return w / jnp.maximum(w.sum(-1, keepdims=True), 1e-8)


def separable_resample(images: jnp.ndarray,
                       scale_y: jnp.ndarray, shift_y: jnp.ndarray,
                       scale_x: jnp.ndarray, shift_x: jnp.ndarray,
                       out_size: int, filter_width: float = 1.0) -> jnp.ndarray:
    """Axis-aligned affine resample (crop / zoom / translate) of
    [B,H,W,C] via two batched matmuls — exact bilinear, no gathers.

    ~45 GFLOP for a 256-batch on the matrix units instead of a
    per-element gather.
    """
    B, H, W, C = images.shape
    x = images.astype(jnp.float32)
    Wy = _axis_weights(scale_y, shift_y, out_size, H, filter_width)
    Wx = _axis_weights(scale_x, shift_x, out_size, W, filter_width)
    x = jnp.einsum("boh,bhwc->bowc", Wy, x)
    x = jnp.einsum("bpw,bowc->bopc", Wx, x)
    return x


def _crop_params(in_size: float, out_size: float, crop_scale: jnp.ndarray,
                 shift_frac: jnp.ndarray):
    """Map (area fraction, [-1,1] center offset) → (scale, shift) for one
    axis of separable_resample."""
    crop_size = in_size * jnp.sqrt(crop_scale)
    scale = crop_size / out_size
    slack = (in_size - crop_size) / 2.0
    center = (in_size - 1.0) / 2.0 + shift_frac * slack
    shift = center - scale * (out_size - 1.0) / 2.0
    return scale, shift


# ---------------------------------------------------------------------------
# color
# ---------------------------------------------------------------------------

def color_jitter(images: jnp.ndarray, key: jax.Array,
                 brightness: float, contrast: float, saturation: float
                 ) -> jnp.ndarray:
    """Per-image random brightness/contrast/saturation on [B,H,W,3] in [0,1]."""
    B = images.shape[0]
    kb, kc, ks = jax.random.split(key, 3)
    bf = 1.0 + jax.random.uniform(kb, (B, 1, 1, 1), minval=-brightness,
                                  maxval=brightness)
    cf = 1.0 + jax.random.uniform(kc, (B, 1, 1, 1), minval=-contrast,
                                  maxval=contrast)
    sf = 1.0 + jax.random.uniform(ks, (B, 1, 1, 1), minval=-saturation,
                                  maxval=saturation)
    x = images * bf
    mean = jnp.mean(x, axis=(1, 2, 3), keepdims=True)
    x = (x - mean) * cf + mean
    gray = jnp.mean(x, axis=-1, keepdims=True)
    x = (x - gray) * sf + gray
    return jnp.clip(x, 0.0, 1.0)


def hue_jitter(images: jnp.ndarray, key: jax.Array, hue: float
               ) -> jnp.ndarray:
    """Per-image random hue rotation on [B,H,W,3] in [0,1] (torchvision
    ColorJitter hue parity, ref `src/train_multimodal.py:332` hue=0.1):
    exact RGB→HSV, h += U(-hue, hue) mod 1, HSV→RGB. Purely elementwise
    (max/min/select), so XLA fuses it into the surrounding augmentation
    chain at zero extra HBM traffic."""
    delta = jax.random.uniform(key, (images.shape[0], 1, 1),
                               minval=-hue, maxval=hue)
    return hue_rotate(images, delta)


def hue_rotate(images: jnp.ndarray, delta: jnp.ndarray) -> jnp.ndarray:
    """Deterministic hue rotation by `delta` [B,1,1] fractions of the
    hue circle (the core of hue_jitter; PIL/colorsys HSV semantics)."""
    r, g, b = images[..., 0], images[..., 1], images[..., 2]
    mx = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    diff = mx - mn
    safe = jnp.where(diff > 0, diff, 1.0)
    h = jnp.where(
        mx == r, (g - b) / safe,
        jnp.where(mx == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe)) / 6.0
    h = jnp.where(diff > 0, jnp.mod(h, 1.0), 0.0)
    s = jnp.where(mx > 0, diff / jnp.maximum(mx, 1e-12), 0.0)
    v = mx

    h = jnp.mod(h + delta, 1.0)

    i = jnp.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(jnp.int32) % 6
    conds = [i == k for k in range(6)]
    r2 = jnp.select(conds, [v, q, p, p, t, v])
    g2 = jnp.select(conds, [t, v, v, q, p, p])
    b2 = jnp.select(conds, [p, p, t, v, v, q])
    return jnp.stack([r2, g2, b2], axis=-1)


def normalize_images(images: jnp.ndarray,
                     dtype: jnp.dtype = jnp.float32) -> jnp.ndarray:
    """[B,H,W,3] in [0,1] (or uint8 0..255) → ImageNet-normalized dtype."""
    x = images.astype(jnp.float32)
    if images.dtype == jnp.uint8:
        x = x / 255.0
    return _normalize01(x, dtype)


def _normalize01(x: jnp.ndarray, dtype) -> jnp.ndarray:
    mean = jnp.asarray(IMAGENET_MEAN)
    std = jnp.asarray(IMAGENET_STD)
    return ((x - mean) / std).astype(dtype)


def gaussian_blur(images: jnp.ndarray, sigma: float = 1.0,
                  kernel_size: int = 5) -> jnp.ndarray:
    """Separable depthwise Gaussian blur on [B,H,W,C] (device-side
    equivalent of the reference's GaussianBlur augment,
    `src/enhanced_augmentation.py:47-50`)."""
    half = kernel_size // 2
    xs = np.arange(-half, half + 1, dtype=np.float32)
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    k = jnp.asarray(k / k.sum(), images.dtype)
    x = images
    # blur along W then H via 1-D convolutions (depthwise)
    x = jax.vmap(lambda im: _conv1d(im, k, axis=1))(x)
    x = jax.vmap(lambda im: _conv1d(im, k, axis=0))(x)
    return x


def _conv1d(img: jnp.ndarray, k: jnp.ndarray, axis: int) -> jnp.ndarray:
    """1-D same-size convolution of [H,W,C] along H (axis 0) or W (axis 1),
    edge-padded, expressed as a stack of static shifts (gather-free)."""
    half = (k.shape[0] - 1) // 2
    out = jnp.zeros_like(img)
    for i in range(k.shape[0]):
        shift = i - half
        if axis == 0:
            if shift >= 0:
                s = jnp.concatenate(
                    [img[shift:], jnp.repeat(img[-1:], shift, 0)], 0) \
                    if shift else img
            else:
                s = jnp.concatenate(
                    [jnp.repeat(img[:1], -shift, 0), img[:shift]], 0)
        else:
            if shift >= 0:
                s = jnp.concatenate(
                    [img[:, shift:], jnp.repeat(img[:, -1:], shift, 1)], 1) \
                    if shift else img
            else:
                s = jnp.concatenate(
                    [jnp.repeat(img[:, :1], -shift, 1), img[:, :shift]], 1)
        out = out + k[i] * s
    return out


def gaussian_noise(images: jnp.ndarray, key: jax.Array,
                   std: float = 0.05) -> jnp.ndarray:
    """Additive Gaussian noise on [0,1] images (ref albumentations
    GaussNoise group, `src/enhanced_augmentation.py:78-84`)."""
    return jnp.clip(images + std * jax.random.normal(key, images.shape,
                                                     images.dtype), 0.0, 1.0)


def random_erasing(images: jnp.ndarray, key: jax.Array, prob: float,
                   area_frac: Tuple[float, float] = (0.02, 0.2)) -> jnp.ndarray:
    """Per-image random rectangle erase (torchvision RandomErasing parity,
    ref `src/enhanced_augmentation.py:60-65`), fixed-shape via masking."""
    B, H, W, _ = images.shape
    kp, ka, ky, kx = jax.random.split(key, 4)
    apply = jax.random.uniform(kp, (B, 1, 1, 1)) < prob
    frac = jax.random.uniform(ka, (B,), minval=area_frac[0], maxval=area_frac[1])
    side_h = jnp.sqrt(frac) * H
    side_w = jnp.sqrt(frac) * W
    y0 = jax.random.uniform(ky, (B,)) * (H - side_h)
    x0 = jax.random.uniform(kx, (B,)) * (W - side_w)
    yy = jnp.arange(H, dtype=jnp.float32)[None, :, None, None]
    xx = jnp.arange(W, dtype=jnp.float32)[None, None, :, None]
    inside = ((yy >= y0[:, None, None, None]) & (yy < (y0 + side_h)[:, None, None, None])
              & (xx >= x0[:, None, None, None]) & (xx < (x0 + side_w)[:, None, None, None]))
    return jnp.where(apply & inside, 0.0, images)


def coarse_dropout(images: jnp.ndarray, key: jax.Array, prob: float,
                   num_holes: int = 8,
                   hole_frac: Tuple[float, float] = (0.02, 0.035)
                   ) -> jnp.ndarray:
    """N-hole generalization of random_erasing (albumentations
    CoarseDropout parity, ref `src/enhanced_augmentation.py:93-99`):
    up to `num_holes` small rectangles zeroed per image, fixed-shape via
    masking (no gathers)."""
    B, H, W, _ = images.shape
    kp, kn, ka, ky, kx = jax.random.split(key, 5)
    apply = jax.random.uniform(kp, (B, 1, 1, 1)) < prob
    # albumentations draws holes in [1, max_holes]
    n_active = jax.random.randint(kn, (B,), 1, num_holes + 1)
    frac = jax.random.uniform(ka, (B, num_holes), minval=hole_frac[0],
                              maxval=hole_frac[1])
    side_h = jnp.sqrt(frac) * H
    side_w = jnp.sqrt(frac) * W
    y0 = jax.random.uniform(ky, (B, num_holes)) * (H - side_h)
    x0 = jax.random.uniform(kx, (B, num_holes)) * (W - side_w)
    active = (jnp.arange(num_holes)[None, :] < n_active[:, None])
    yy = jnp.arange(H, dtype=jnp.float32)[None, None, :, None]
    xx = jnp.arange(W, dtype=jnp.float32)[None, None, None, :]
    inside = ((yy >= y0[:, :, None, None]) & (yy < (y0 + side_h)[:, :, None, None])
              & (xx >= x0[:, :, None, None]) & (xx < (x0 + side_w)[:, :, None, None])
              & active[:, :, None, None])
    hole = jnp.any(inside, axis=1)[..., None]  # [B,H,W,1]
    return jnp.where(apply & hole, 0.0, images)


def perspective_resample(images: jnp.ndarray, homographies: jnp.ndarray,
                         out_size: int) -> jnp.ndarray:
    """Batched projective warp: [B,H,W,C] x [B,3,3] -> [B,out,out,C].

    `homographies` map OUTPUT (y, x, 1) to INPUT homogeneous coords.
    Gather-based like affine_resample — parity path, not a hot path.
    """
    images = images.astype(jnp.float32)

    def one(img, Hm):
        ii = jnp.arange(out_size, dtype=jnp.float32)
        gy, gx = jnp.meshgrid(ii, ii, indexing="ij")
        d = Hm[2, 0] * gy + Hm[2, 1] * gx + Hm[2, 2]
        d = jnp.where(jnp.abs(d) < 1e-8, 1e-8, d)
        ys = (Hm[0, 0] * gy + Hm[0, 1] * gx + Hm[0, 2]) / d
        xs = (Hm[1, 0] * gy + Hm[1, 1] * gx + Hm[1, 2]) / d
        return _bilinear_sample(img, ys, xs)

    return jax.vmap(one)(images, homographies)


def _solve_homography(src: jnp.ndarray, dst: jnp.ndarray) -> jnp.ndarray:
    """DLT: 4 point pairs (y,x) src→dst per image → [B,3,3] H with
    H @ (src_y, src_x, 1) ∝ (dst_y, dst_x, 1)."""
    B = src.shape[0]
    rows = []
    for i in range(4):
        sy, sx = src[:, i, 0], src[:, i, 1]
        dy, dx = dst[:, i, 0], dst[:, i, 1]
        one = jnp.ones_like(sy)
        zero = jnp.zeros_like(sy)
        rows.append(jnp.stack([sy, sx, one, zero, zero, zero,
                               -dy * sy, -dy * sx], -1))
        rows.append(jnp.stack([zero, zero, zero, sy, sx, one,
                               -dx * sy, -dx * sx], -1))
    A = jnp.stack(rows, axis=1)                              # [B, 8, 8]
    b = jnp.stack([jnp.stack([dst[:, i, 0], dst[:, i, 1]], -1)
                   for i in range(4)], 1).reshape(B, 8)
    h = jnp.linalg.solve(A, b[..., None])[..., 0]            # [B, 8]
    return jnp.concatenate([h, jnp.ones((B, 1), h.dtype)],
                           -1).reshape(B, 3, 3)


def random_perspective(images: jnp.ndarray, key: jax.Array,
                       distortion_scale: float = 0.2, prob: float = 0.5
                       ) -> jnp.ndarray:
    """torchvision RandomPerspective parity (ref
    `src/enhanced_augmentation.py:44-46`): each corner is displaced
    inward by U(0, distortion_scale·half); the image is warped so the
    full frame maps onto the displaced quad."""
    B, H, W, _ = images.shape
    kc, kp = jax.random.split(key)
    d = jax.random.uniform(kc, (B, 4, 2)) * distortion_scale
    corners = jnp.asarray([[0.0, 0.0], [0.0, W - 1.0],
                           [H - 1.0, 0.0], [H - 1.0, W - 1.0]],
                          jnp.float32)
    sign = jnp.asarray([[1, 1], [1, -1], [-1, 1], [-1, -1]], jnp.float32)
    half = jnp.asarray([(H - 1) / 2.0, (W - 1) / 2.0], jnp.float32)
    endpoints = corners[None] + sign[None] * d * half[None, None]
    # output→input map: output frame corners come FROM the endpoints
    Hm = _solve_homography(jnp.broadcast_to(corners[None], endpoints.shape),
                           endpoints)
    warped = perspective_resample(images, Hm, H)
    apply = jax.random.uniform(kp, (B, 1, 1, 1)) < prob
    return jnp.where(apply, warped, images.astype(jnp.float32))


def _clahe_interp_weights(size: int, grid: int) -> np.ndarray:
    """[size, grid] bilinear weights of each tile's CDF for each pixel
    coordinate (≤2 nonzeros per row; border pixels clamp to the edge
    tile, matching OpenCV/albumentations border handling)."""
    tile = size / grid
    pos = (np.arange(size) + 0.5) / tile - 0.5   # tile-center coords
    pos = np.clip(pos, 0.0, grid - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, grid - 1)
    w_hi = pos - lo
    weights = np.zeros((size, grid), np.float32)
    weights[np.arange(size), lo] += 1.0 - w_hi
    weights[np.arange(size), hi] += w_hi
    return weights


def clahe_batch_tiled(images: jnp.ndarray, clip_limit: float = 4.0,
                      num_bins: int = 64, grid: int = 8) -> jnp.ndarray:
    """True CLAHE: 8×8-tiled adaptive histogram equalization with
    bilinear interpolation between tile mappings, on the luminance
    channel of [B,H,W,3] in [0,1] (albumentations CLAHE semantics, ref
    `src/enhanced_augmentation.py:85-92`).

    Gather-free: per-tile histograms come from a one-hot
    reduction, and the per-pixel CDF is a bilinear blend of the 4
    surrounding tile CDFs expressed as two small static matmuls
    ([H,G]·[G,bins] then [W,G]·[G,bins]) — no dynamic indexing anywhere.
    Requires H and W divisible by `grid` (224/8 = 28 in the default
    pipeline); callers fall back to `clahe_batch` otherwise.
    """
    x = images.astype(jnp.float32)
    lum = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    B, H, W = lum.shape
    G = grid
    th, tw = H // G, W // G
    n_tile = th * tw

    idx = jnp.clip((lum * num_bins).astype(jnp.int32), 0, num_bins - 1)
    onehot = jax.nn.one_hot(idx, num_bins, dtype=jnp.float32)  # [B,H,W,K]
    tiles = onehot.reshape(B, G, th, G, tw, num_bins)
    hist = jnp.sum(tiles, axis=(2, 4))                         # [B,G,G,K]

    limit = clip_limit * n_tile / num_bins
    clipped = jnp.minimum(hist, limit)
    excess = jnp.sum(hist - clipped, axis=-1, keepdims=True) / num_bins
    hist = clipped + excess
    cdf = jnp.cumsum(hist, axis=-1) / n_tile                   # [B,G,G,K]

    wy = jnp.asarray(_clahe_interp_weights(H, G))              # [H,G]
    wx = jnp.asarray(_clahe_interp_weights(W, G))              # [W,G]
    cdf_y = jnp.einsum("yr,brck->byck", wy, cdf)               # [B,H,G,K]
    cdf_pix = jnp.einsum("xc,byck->byxk", wx, cdf_y)           # [B,H,W,K]
    mapped = jnp.sum(onehot * cdf_pix, axis=-1)                # [B,H,W]

    ratio = mapped / jnp.maximum(lum, 1e-6)
    return jnp.clip(x * ratio[..., None], 0.0, 1.0)


def clahe_batch(images: jnp.ndarray, clip_limit: float = 4.0,
                num_bins: int = 64) -> jnp.ndarray:
    """Contrast-limited GLOBAL histogram equalization on the luminance
    channel of [B,H,W,3] in [0,1] — the cheap fallback for sizes not
    divisible by the CLAHE tile grid (one CDF per image; see
    `clahe_batch_tiled` for the real 8×8 CLAHE).

    The clip limit is expressed as a multiple of the uniform bin count
    (albumentations semantics); excess mass is redistributed uniformly.
    """
    x = images.astype(jnp.float32)
    lum = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    B, H, W = lum.shape
    n = H * W
    idx = jnp.clip((lum * num_bins).astype(jnp.int32), 0, num_bins - 1)
    onehot = jax.nn.one_hot(idx, num_bins, dtype=jnp.float32)
    hist = jnp.sum(onehot, axis=(1, 2))                      # [B, bins]
    limit = clip_limit * n / num_bins
    clipped = jnp.minimum(hist, limit)
    excess = (jnp.sum(hist - clipped, axis=-1, keepdims=True) / num_bins)
    hist = clipped + excess
    cdf = jnp.cumsum(hist, axis=-1) / n                      # [B, bins]
    # map each pixel's luminance through the per-image CDF (one-hot dot —
    # gather-free) and rescale RGB by the luminance ratio
    mapped = jnp.einsum("bhwk,bk->bhw", onehot, cdf)
    ratio = mapped / jnp.maximum(lum, 1e-6)
    return jnp.clip(x * ratio[..., None], 0.0, 1.0)


def elastic_transform(images: jnp.ndarray, key: jax.Array,
                      alpha: float = 30.0, sigma: float = 6.0,
                      prob: float = 1.0) -> jnp.ndarray:
    """Elastic deformation (albumentations ElasticTransform parity, ref
    `src/enhanced_augmentation.py:100-106`): a Gaussian-smoothed random
    displacement field bends the sampling grid. Gather-based — parity
    path for the albumentations-tier stack, off by default."""
    B, H, W, _ = images.shape
    kd, kp = jax.random.split(key)
    disp = jax.random.uniform(kd, (B, H, W, 2), minval=-1.0, maxval=1.0)
    disp = gaussian_blur(disp, sigma=sigma,
                         kernel_size=int(2 * np.ceil(2 * sigma) + 1)) * alpha

    def one(img, d):
        ii = jnp.arange(H, dtype=jnp.float32)
        jj = jnp.arange(W, dtype=jnp.float32)
        gy, gx = jnp.meshgrid(ii, jj, indexing="ij")
        return _bilinear_sample(img, gy + d[..., 0], gx + d[..., 1])

    warped = jax.vmap(one)(images.astype(jnp.float32), disp)
    apply = jax.random.uniform(kp, (B, 1, 1, 1)) < prob
    return jnp.where(apply, warped, images.astype(jnp.float32))


# ---------------------------------------------------------------------------
# public pipelines
# ---------------------------------------------------------------------------

def train_preprocess(
    images_uint8: jnp.ndarray,  # [B, S, S, 3] uint8 staging (S=256)
    key: jax.Array,
    cfg: Config,
    dtype: jnp.dtype = jnp.float32,
) -> jnp.ndarray:
    """Full random train augmentation → [B, image_size, image_size, 3].

    geometry_mode='separable' (default): flip + random resized crop as
    batched-matmul bilinear resampling, rotation as the 3-shear pass
    (ops/rotate.py). 'gather': the reference-exact single-pass affine
    (crop∘rotate∘flip in one bilinear gather).
    """
    d = cfg.data
    B = images_uint8.shape[0]
    in_size = images_uint8.shape[1]
    # All augmentation subkeys are derived once from the top-level key.
    # Never re-split a key already passed into a consumer: split(k, 2)
    # is a prefix of split(k, 3), so re-splitting k_jit after
    # color_jitter consumed it would correlate hue with contrast draws.
    (k_scale, k_angle, k_flip, k_sy, k_sx, k_jit, k_hue, k_bsel,
     k_noise, k_erase, k_persp, k_clahe_sel, k_elastic,
     k_dropout) = jax.random.split(key, 14)

    crop_scale = jax.random.uniform(k_scale, (B,), minval=d.crop_scale_min,
                                    maxval=1.0)
    max_rad = np.deg2rad(d.rotation_degrees)
    angle = jax.random.uniform(k_angle, (B,), minval=-max_rad, maxval=max_rad)
    flip = (jax.random.uniform(k_flip, (B,)) < d.horizontal_flip_prob
            ).astype(jnp.float32)
    sy = jax.random.uniform(k_sy, (B,), minval=-1.0, maxval=1.0)
    sx = jax.random.uniform(k_sx, (B,), minval=-1.0, maxval=1.0)

    if d.geometry_mode == "gather":
        mats = jax.vmap(partial(_compose_affine, float(in_size),
                                float(d.image_size)))(crop_scale, angle, flip,
                                                      sy, sx)
        x = affine_resample(images_uint8, mats, d.image_size) / 255.0
    else:
        x = images_uint8.astype(jnp.float32)
        # horizontal flip: lane reverse selected per image
        x = jnp.where(flip[:, None, None, None] > 0, x[:, :, ::-1, :], x)
        scale_y, shift_y = _crop_params(float(in_size), float(d.image_size),
                                        crop_scale, sy)
        scale_x, shift_x = _crop_params(float(in_size), float(d.image_size),
                                        crop_scale, sx)
        x = separable_resample(x, scale_y, shift_y, scale_x, shift_x,
                               d.image_size) / 255.0
        if d.rotation_degrees > 0 and d.online_rotation:
            # AFTER the crop, at image_size — the reference's own order
            # (Resize → RandomCrop → flip → RandomRotation,
            # src/train_multimodal.py:320-324), and ~40% cheaper than
            # rotating the 256-staging frame. bf16 through the shears:
            # halves the bandwidth; the ~0.4% relative rounding is the
            # same order as uint8 quantization (train-aug only).
            from multimodal_rare_disease.ops.rotate import rotate_batch

            x = rotate_batch(x.astype(jnp.bfloat16), angle,
                             max_degrees=d.rotation_degrees
                             ).astype(jnp.float32)

    x = color_jitter(x, k_jit, d.brightness_factor, d.contrast_factor,
                     d.saturation_factor)
    if getattr(d, "hue_factor", 0.0) > 0:
        x = hue_jitter(x, k_hue, d.hue_factor)
    if d.gaussian_blur_prob > 0 or d.gaussian_noise_std > 0:
        if d.gaussian_blur_prob > 0:
            blurred = gaussian_blur(x)
            sel = (jax.random.uniform(k_bsel, (B,)) < d.gaussian_blur_prob)
            x = jnp.where(sel[:, None, None, None], blurred, x)
        if d.gaussian_noise_std > 0:
            x = gaussian_noise(x, k_noise, d.gaussian_noise_std)
    if d.random_erasing_prob > 0:
        x = random_erasing(x, k_erase, d.random_erasing_prob)
    # albumentations-tier extras (all default-off, ref
    # src/enhanced_augmentation.py:28-128)
    if getattr(d, "perspective_prob", 0.0) > 0:
        x = random_perspective(x, k_persp, d.perspective_distortion,
                               d.perspective_prob)
    if getattr(d, "clahe_prob", 0.0) > 0:
        if x.shape[1] % 8 == 0 and x.shape[2] % 8 == 0:
            eq = clahe_batch_tiled(x)
        else:
            eq = clahe_batch(x)
        sel = jax.random.uniform(k_clahe_sel, (B, 1, 1, 1)) < d.clahe_prob
        x = jnp.where(sel, eq, x)
    if getattr(d, "elastic_prob", 0.0) > 0:
        x = elastic_transform(x, k_elastic, prob=d.elastic_prob)
    if getattr(d, "coarse_dropout_prob", 0.0) > 0:
        x = coarse_dropout(x, k_dropout, d.coarse_dropout_prob,
                           num_holes=d.coarse_dropout_holes)
    return _normalize01(x, dtype)


def eval_resample_params(in_size: int, image_size: int, mode: str
                         ) -> Tuple[float, float, float]:
    """(scale, shift, filter_width) for the deterministic eval resample,
    PIL half-pixel convention: src(o) = scale*o + shift.

    mode='resize_crop': Resize(image_size+10) + CenterCrop(image_size) —
      the reference's multimodal val transform
      (`src/train_multimodal.py:343-353`). Composed into one resample:
      resize in→R (R = image_size+10), then take the central image_size
      pixels, i.e. src(o) = (o + off + 0.5)*(in/R) - 0.5, off = (R-out)/2.
    mode='resize': plain Resize(image_size) — the reference loader's val
      path (`src/image_dataset_loader.py:123-140`).

    filter_width is PIL's antialiasing triangle width (the downscale
    factor), so the output matches torchvision Resize(antialias) bilinear.
    """
    if mode == "resize":
        resize_size = image_size
    elif mode == "resize_crop":
        resize_size = image_size + 10
    else:
        raise ValueError(f"unknown eval_transform {mode!r}")
    scale = in_size / resize_size
    offset = (resize_size - image_size) / 2.0
    shift = (offset + 0.5) * scale - 0.5
    return scale, shift, max(scale, 1.0)


def eval_preprocess(
    images_uint8: jnp.ndarray,  # [B, S, S, 3] uint8
    cfg: Config,
    dtype: jnp.dtype = jnp.float32,
) -> jnp.ndarray:
    """Deterministic eval transform → normalize (clean val transforms —
    deliberately NOT reproducing the reference's val-noise quirk,
    `src/train_small_data.py:93-109`).

    Geometry is selected by cfg.data.eval_transform ('resize_crop' |
    'resize', see eval_resample_params) and matches the corresponding
    torchvision/PIL transform stack bilinearly, including antialiasing.
    """
    d = cfg.data
    B = images_uint8.shape[0]
    in_size = images_uint8.shape[1]
    if in_size == d.image_size:
        # Staged at target size: host already applied the eval geometry
        # (inference fast path) — only normalize on device. Elementwise
        # and memory-bound: XLA fuses it into one pass or into the stem
        # conv's input.
        return _normalize01(images_uint8.astype(jnp.float32) / 255.0, dtype)
    scale, shift, fw = eval_resample_params(
        in_size, d.image_size, getattr(d, "eval_transform", "resize_crop"))
    scale_b = jnp.full((B,), scale, jnp.float32)
    shift_b = jnp.full((B,), shift, jnp.float32)
    x = separable_resample(images_uint8, scale_b, shift_b, scale_b, shift_b,
                           d.image_size, filter_width=fw) / 255.0
    return _normalize01(x, dtype)


def augment_batch(images_uint8, key, cfg, train: bool,
                  dtype=jnp.float32) -> jnp.ndarray:
    if train:
        return train_preprocess(images_uint8, key, cfg, dtype)
    return eval_preprocess(images_uint8, cfg, dtype)
