import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_rare_disease.config import resolve_config
from multimodal_rare_disease.ops import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    affine_resample,
    eval_preprocess,
    normalize_images,
    train_preprocess,
)


def test_normalize_matches_formula():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, size=(2, 8, 8, 3), dtype=np.uint8)
    out = np.asarray(normalize_images(jnp.asarray(u8)))
    expect = (u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    np.testing.assert_allclose(out, expect, atol=1e-5)


def test_eval_preprocess_staged_at_target_is_plain_normalize():
    """A batch staged at image_size skips the resample: the predict path
    is the elementwise normalize alone, equal to the numpy formula."""
    cfg = resolve_config()
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, size=(2, 224, 224, 3), dtype=np.uint8)
    out = np.asarray(jax.jit(lambda a: eval_preprocess(a, cfg))(u8))
    expect = (u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    np.testing.assert_allclose(out, expect, atol=1e-5)


def test_eval_preprocess_staged_at_target_bf16():
    cfg = resolve_config()
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, size=(1, 224, 224, 3), dtype=np.uint8)
    out = eval_preprocess(jnp.asarray(u8), cfg, dtype=jnp.bfloat16)
    assert out.dtype == jnp.bfloat16 and out.shape == u8.shape
    expect = (u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    np.testing.assert_allclose(np.asarray(out, np.float32), expect, atol=2e-2)


def test_affine_identity():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, size=(1, 32, 32, 3)).astype(np.float32)
    ident = jnp.asarray(np.stack([np.array([[1, 0, 0], [0, 1, 0]], np.float32)]))
    out = np.asarray(affine_resample(jnp.asarray(img), ident, 32))
    np.testing.assert_allclose(out, img, atol=1e-4)


def test_eval_preprocess_deterministic_and_shaped():
    cfg = resolve_config()
    rng = np.random.default_rng(4)
    u8 = jnp.asarray(rng.integers(0, 256, (3, 256, 256, 3), dtype=np.uint8))
    a = np.asarray(eval_preprocess(u8, cfg))
    b = np.asarray(eval_preprocess(u8, cfg))
    assert a.shape == (3, 224, 224, 3)
    np.testing.assert_array_equal(a, b)
    # center content preserved: uniform image normalizes exactly
    flat = jnp.full((1, 256, 256, 3), 128, jnp.uint8)
    out = np.asarray(eval_preprocess(flat, cfg))
    expect = (128 / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    np.testing.assert_allclose(out[0, 112, 112], expect, atol=1e-3)


def test_train_preprocess_shapes_and_randomness():
    cfg = resolve_config()
    rng = np.random.default_rng(5)
    u8 = jnp.asarray(rng.integers(0, 256, (4, 256, 256, 3), dtype=np.uint8))
    k1, k2 = jax.random.split(jax.random.key(0))
    a = np.asarray(train_preprocess(u8, k1, cfg))
    b = np.asarray(train_preprocess(u8, k2, cfg))
    c = np.asarray(train_preprocess(u8, k1, cfg))
    assert a.shape == (4, 224, 224, 3)
    assert np.isfinite(a).all()
    assert np.abs(a - b).max() > 1e-3  # different keys → different augment
    np.testing.assert_array_equal(a, c)  # same key → identical


def test_train_preprocess_jits_and_runs_sharded(mesh8):
    from multimodal_rare_disease.parallel import shard_batch

    cfg = resolve_config()
    rng = np.random.default_rng(6)
    u8 = rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)
    batch = shard_batch(mesh8, {"img": u8})
    fn = jax.jit(lambda x, k: train_preprocess(x, k, cfg))
    out = fn(batch["img"], jax.random.key(1))
    assert out.shape == (8, 224, 224, 3)
    assert np.isfinite(np.asarray(out)).all()


def test_random_erasing_zeroes_region():
    from multimodal_rare_disease.ops.preprocess import random_erasing

    x = jnp.ones((4, 32, 32, 3))
    out = np.asarray(random_erasing(x, jax.random.key(0), prob=1.0))
    # every image should have a zeroed rectangle
    for i in range(4):
        assert (out[i] == 0).any()
        assert (out[i] == 1).any()


def test_gaussian_blur_and_noise():
    from multimodal_rare_disease.ops.preprocess import (
        gaussian_blur,
        gaussian_noise,
    )

    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32))
    b = np.asarray(gaussian_blur(x, sigma=1.0))
    assert b.shape == x.shape
    # blur reduces variance, preserves mean
    assert b.std() < np.asarray(x).std()
    np.testing.assert_allclose(b.mean(), np.asarray(x).mean(), atol=0.02)
    # uniform image unchanged (edge handling correct)
    flat = jnp.full((1, 16, 16, 3), 0.5)
    np.testing.assert_allclose(np.asarray(gaussian_blur(flat)), 0.5, atol=1e-5)

    n = np.asarray(gaussian_noise(x, jax.random.key(0), std=0.1))
    assert 0.05 < np.abs(n - np.asarray(x)).mean() < 0.15
    assert n.min() >= 0 and n.max() <= 1


def test_train_preprocess_with_blur_noise_flags():
    cfg2 = resolve_config("default", {"data.gaussian_blur_prob": 0.5,
                                      "data.gaussian_noise_std": 0.05})
    rng = np.random.default_rng(8)
    u8 = jnp.asarray(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8))
    cfg3 = resolve_config("default", {"data.gaussian_blur_prob": 0.5,
                                      "data.gaussian_noise_std": 0.05,
                                      "data.image_size": 32})
    out = train_preprocess(u8, jax.random.key(0), cfg3)
    assert out.shape == (4, 32, 32, 3)
    assert np.isfinite(np.asarray(out)).all()
    del cfg2


# ---------------------------------------------------------------------------
# PIL-parity for the deterministic eval geometry (VERDICT r1 item 4):
# our one-pass separable resample must equal torchvision's
# Resize(+10)+CenterCrop (multimodal val, ref src/train_multimodal.py:343-353)
# and plain Resize (loader val, ref src/image_dataset_loader.py:123-140),
# both of which are PIL bilinear with antialiasing.
# ---------------------------------------------------------------------------

def _pil_reference(u8_img, mode, image_size=224):
    from PIL import Image

    im = Image.fromarray(u8_img)
    if mode == "resize_crop":
        r = image_size + 10
        im = im.resize((r, r), Image.BILINEAR)
        off = (r - image_size) // 2
        arr = np.asarray(im)[off:off + image_size, off:off + image_size]
    else:
        arr = np.asarray(im.resize((image_size, image_size), Image.BILINEAR))
    x = arr.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def _real_corpus_image():
    from pathlib import Path

    from PIL import Image

    p = sorted(Path("/root/reference/data/images").glob("*.png"))
    if not p:
        pytest.skip("reference corpus not available")
    return np.asarray(Image.open(p[0]).convert("RGB"))


@pytest.mark.parametrize("mode", ["resize_crop", "resize"])
def test_eval_preprocess_matches_pil(mode):
    img = _real_corpus_image()
    assert img.shape == (256, 256, 3)
    cfg = resolve_config(overrides={"data.eval_transform": mode})
    ours = np.asarray(
        eval_preprocess(jnp.asarray(img[None]), cfg))[0]
    ref = _pil_reference(img, mode)
    # PIL rounds the resized image to uint8 (±0.5/255 per pixel, ~0.009
    # after /std); our path stays float throughout.
    np.testing.assert_allclose(ours, ref, atol=2.5e-2)
    # mean |err| floor from PIL's uint8 output rounding is ~0.0044 (/std);
    # anything well above that would indicate a geometry mismatch
    assert float(np.abs(ours - ref).mean()) < 6.5e-3


def test_eval_resize_crop_actually_crops():
    # Regression for the round-1 self-cancelling crop_scale formula: a
    # border-only feature must be cropped out by resize_crop geometry.
    from multimodal_rare_disease.ops.preprocess import eval_resample_params

    scale, shift, fw = eval_resample_params(256, 224, "resize_crop")
    # first output pixel samples strictly inside the image (border cropped)
    assert shift > 4.0, (scale, shift)
    # and resize mode starts at the border
    scale_r, shift_r, _ = eval_resample_params(256, 224, "resize")
    assert abs(shift_r - (0.5 * scale_r - 0.5)) < 1e-6

    img = np.zeros((256, 256, 3), np.uint8)
    img[:2, :, :] = 255  # bright top border strip
    cfg = resolve_config(overrides={"data.eval_transform": "resize_crop"})
    out = np.asarray(
        eval_preprocess(jnp.asarray(img[None]), cfg))[0]
    black = (np.zeros(3, np.float32) - IMAGENET_MEAN) / IMAGENET_STD
    # top row of the output equals normalized black: the strip was cropped
    np.testing.assert_allclose(out[0], np.broadcast_to(black, out[0].shape),
                               atol=1e-3)


# ---------------------------------------------------------------------------
# hue jitter (ref ColorJitter hue=0.1, src/train_multimodal.py:332)
# ---------------------------------------------------------------------------

def test_hue_rotate_matches_colorsys():
    import colorsys

    from multimodal_rare_disease.ops.preprocess import hue_rotate

    rng = np.random.default_rng(3)
    px = rng.uniform(0, 1, (1, 4, 4, 3)).astype(np.float32)
    delta = 0.07
    out = np.asarray(hue_rotate(jnp.asarray(px),
                                jnp.full((1, 1, 1), delta, jnp.float32)))
    for i in range(4):
        for j in range(4):
            h, s, v = colorsys.rgb_to_hsv(*px[0, i, j])
            ref = colorsys.hsv_to_rgb((h + delta) % 1.0, s, v)
            np.testing.assert_allclose(out[0, i, j], ref, atol=1e-5)


def test_hue_rotate_preserves_gray_and_value():
    from multimodal_rare_disease.ops.preprocess import hue_rotate

    gray = np.full((1, 2, 2, 3), 0.5, np.float32)
    out = np.asarray(hue_rotate(jnp.asarray(gray),
                                jnp.full((1, 1, 1), 0.3, jnp.float32)))
    np.testing.assert_allclose(out, gray, atol=1e-6)

    rng = np.random.default_rng(4)
    px = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    out = np.asarray(hue_rotate(jnp.asarray(px),
                                jnp.full((2, 1, 1), -0.09, jnp.float32)))
    # value (max channel) and saturation are invariant under hue rotation
    np.testing.assert_allclose(out.max(-1), px.max(-1), atol=1e-5)
    np.testing.assert_allclose(out.min(-1), px.min(-1), atol=1e-5)


def test_train_preprocess_with_hue():
    cfg = resolve_config(overrides={"data.image_size": 32,
                                    "data.hue_factor": 0.1,
                                    "data.online_rotation": False})
    u8 = jnp.asarray(np.random.default_rng(0).integers(
        0, 256, (4, 48, 48, 3), dtype=np.uint8))
    out = train_preprocess(u8, jax.random.key(1), cfg)
    assert out.shape == (4, 32, 32, 3)
    assert np.isfinite(np.asarray(out)).all()


# ---------------------------------------------------------------------------
# albumentations-tier extras (ref src/enhanced_augmentation.py:28-128)
# ---------------------------------------------------------------------------

def test_coarse_dropout_zeroes_holes():
    from multimodal_rare_disease.ops.preprocess import coarse_dropout

    x = jnp.ones((4, 32, 32, 3), jnp.float32)
    out = np.asarray(coarse_dropout(x, jax.random.key(0), prob=1.0))
    assert out.min() == 0.0  # at least one hole cut
    assert out.mean() > 0.8  # holes are small
    # prob=0 leaves the image untouched
    out0 = np.asarray(coarse_dropout(x, jax.random.key(0), prob=0.0))
    np.testing.assert_array_equal(out0, np.ones_like(out0))


def test_random_perspective_identity_and_warp():
    from multimodal_rare_disease.ops.preprocess import (
        _solve_homography,
        perspective_resample,
    )

    # identity homography reproduces the image
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    eye = jnp.broadcast_to(jnp.eye(3), (2, 3, 3))
    out = np.asarray(perspective_resample(jnp.asarray(img), eye, 16))
    np.testing.assert_allclose(out, img, atol=1e-5)

    # DLT: solving corners->corners gives identity mapping of the corners
    c = jnp.asarray([[[0.0, 0], [0, 15], [15, 0], [15, 15]]] * 2)
    H = _solve_homography(c, c)
    np.testing.assert_allclose(np.asarray(H[0]), np.eye(3), atol=1e-4)


def test_clahe_increases_contrast_of_flat_image():
    from multimodal_rare_disease.ops.preprocess import clahe_batch

    rng = np.random.default_rng(1)
    # low-contrast image clustered around 0.5
    x = (0.5 + 0.05 * rng.standard_normal((1, 32, 32, 3))).astype(np.float32)
    x = np.clip(x, 0, 1)
    out = np.asarray(clahe_batch(jnp.asarray(x)))
    assert np.isfinite(out).all()
    assert out.std() > x.std() * 1.2  # contrast stretched


def _numpy_tiled_clahe(x: np.ndarray, clip_limit: float = 4.0,
                       num_bins: int = 64, grid: int = 8) -> np.ndarray:
    """Straightforward per-pixel reference for 8×8-tiled CLAHE (OpenCV
    border convention: edge pixels clamp to the edge tile). Independent
    of the matmul formulation in `clahe_batch_tiled` — loops over pixels
    and bilinearly blends the 4 surrounding tile CDFs."""
    B, H, W, _ = x.shape
    th, tw = H // grid, W // grid
    n_tile = th * tw
    out = np.empty_like(x)
    for b in range(B):
        lum = (0.299 * x[b, ..., 0] + 0.587 * x[b, ..., 1]
               + 0.114 * x[b, ..., 2])
        idx = np.clip((lum * num_bins).astype(np.int64), 0, num_bins - 1)
        cdfs = np.zeros((grid, grid, num_bins))
        for r in range(grid):
            for c in range(grid):
                tile = idx[r * th:(r + 1) * th, c * tw:(c + 1) * tw]
                hist = np.bincount(tile.ravel(), minlength=num_bins
                                   ).astype(np.float64)
                limit = clip_limit * n_tile / num_bins
                clipped = np.minimum(hist, limit)
                hist = clipped + (hist - clipped).sum() / num_bins
                cdfs[r, c] = np.cumsum(hist) / n_tile
        mapped = np.empty_like(lum)
        for i in range(H):
            py = np.clip((i + 0.5) / th - 0.5, 0.0, grid - 1.0)
            r0 = int(np.floor(py)); r1 = min(r0 + 1, grid - 1)
            wy = py - r0
            for j in range(W):
                px = np.clip((j + 0.5) / tw - 0.5, 0.0, grid - 1.0)
                c0 = int(np.floor(px)); c1 = min(c0 + 1, grid - 1)
                wx = px - c0
                k = idx[i, j]
                mapped[i, j] = ((1 - wy) * (1 - wx) * cdfs[r0, c0, k]
                                + (1 - wy) * wx * cdfs[r0, c1, k]
                                + wy * (1 - wx) * cdfs[r1, c0, k]
                                + wy * wx * cdfs[r1, c1, k])
        ratio = mapped / np.maximum(lum, 1e-6)
        out[b] = np.clip(x[b] * ratio[..., None], 0.0, 1.0)
    return out


def test_tiled_clahe_parity_with_numpy_reference():
    from multimodal_rare_disease.ops.preprocess import clahe_batch_tiled

    rng = np.random.default_rng(7)
    # structured image: gradient + noise so tiles get distinct histograms
    g = np.linspace(0.1, 0.9, 48)[None, :, None, None]
    x = np.clip(g + 0.15 * rng.standard_normal((2, 48, 48, 3)), 0, 1
                ).astype(np.float32)
    got = np.asarray(clahe_batch_tiled(jnp.asarray(x), grid=8))
    want = _numpy_tiled_clahe(x.astype(np.float64), grid=8)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_tiled_clahe_adapts_locally_where_global_cannot():
    from multimodal_rare_disease.ops.preprocess import (
        clahe_batch, clahe_batch_tiled)

    rng = np.random.default_rng(3)
    # left half dark low-contrast, right half bright low-contrast:
    # tiled CLAHE stretches each half locally; global equalization
    # mostly separates the halves instead.
    x = np.empty((1, 64, 64, 3), np.float32)
    x[:, :, :32] = 0.2 + 0.03 * rng.standard_normal((1, 64, 32, 3))
    x[:, :, 32:] = 0.8 + 0.03 * rng.standard_normal((1, 64, 32, 3))
    x = np.clip(x, 0, 1)
    tiled = np.asarray(clahe_batch_tiled(jnp.asarray(x), clip_limit=10.0))
    glob = np.asarray(clahe_batch(jnp.asarray(x), clip_limit=10.0))
    # local contrast (std within each half) must improve more under tiled
    def half_std(a):
        return a[:, :, :32].std() + a[:, :, 32:].std()
    assert half_std(tiled) > half_std(glob) * 1.1
    assert half_std(tiled) > half_std(x) * 2.0
    assert np.isfinite(tiled).all()


def test_elastic_transform_shapes_and_identity_amplitude():
    from multimodal_rare_disease.ops.preprocess import elastic_transform

    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (2, 24, 24, 3)).astype(np.float32)
    out = np.asarray(elastic_transform(jnp.asarray(img), jax.random.key(3),
                                       alpha=5.0, sigma=3.0))
    assert out.shape == img.shape
    assert np.isfinite(out).all()
    # alpha=0 → identity
    out0 = np.asarray(elastic_transform(jnp.asarray(img), jax.random.key(3),
                                        alpha=0.0, sigma=3.0))
    np.testing.assert_allclose(out0, img, atol=1e-5)


def test_train_preprocess_with_extras_enabled():
    cfg = resolve_config(overrides={
        "data.image_size": 32,
        "data.perspective_prob": 0.5,
        "data.clahe_prob": 0.5,
        "data.elastic_prob": 0.3,
        "data.coarse_dropout_prob": 0.5,
        "data.online_rotation": False,
    })
    u8 = jnp.asarray(np.random.default_rng(0).integers(
        0, 256, (4, 48, 48, 3), dtype=np.uint8))
    out = train_preprocess(u8, jax.random.key(1), cfg)
    assert out.shape == (4, 32, 32, 3)
    assert np.isfinite(np.asarray(out)).all()


def test_augmentation_subkeys_decorrelated():
    """Regression: hue draws must not be correlated with color-jitter
    contrast draws (advisor r2: re-splitting an already-consumed key made
    hue delta == (contrast-1)/2 exactly for every image)."""
    key = jax.random.key(0)
    ks = jax.random.split(key, 14)
    k_jit, k_hue = ks[5], ks[6]
    _, kc, _ = jax.random.split(k_jit, 3)  # color_jitter's contrast key
    B = 256
    contrast = np.asarray(jax.random.uniform(kc, (B,), minval=0.7, maxval=1.3))
    hue = np.asarray(jax.random.uniform(k_hue, (B,), minval=-0.1, maxval=0.1))
    corr = np.corrcoef(contrast, hue)[0, 1]
    assert abs(corr) < 0.3, f"hue/contrast correlated: {corr}"
