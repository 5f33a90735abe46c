import numpy as np
import jax
import jax.numpy as jnp

from multimodal_rare_disease.ops.rotate import rotate_batch
from multimodal_rare_disease.ops.preprocess import (
    affine_resample,
    separable_resample,
)


def test_rotate_zero_angle_identity():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32))
    out = rotate_batch(x, jnp.zeros(2))
    np.testing.assert_allclose(np.asarray(out), np.asarray(x), atol=1e-4)


def test_rotate_matches_gather_affine():
    """Paeth 3-shear must agree with the exact single-pass bilinear gather
    (up to interpolation differences) on a smooth image."""
    S = 64
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / S
    smooth = (np.sin(2 * np.pi * 1.5 * xx) + np.cos(2 * np.pi * 1.5 * yy))
    img = np.repeat(smooth[None, :, :, None], 3, axis=-1) * 60 + 128
    img = jnp.asarray(np.repeat(img, 2, axis=0))

    theta = np.deg2rad(10.0)
    angles = jnp.asarray([theta, -theta], jnp.float32)
    out3 = np.asarray(rotate_batch(img, angles, max_degrees=15.0))

    cos, sin = np.cos(theta), np.sin(theta)
    cc = (S - 1) / 2.0
    mats = []
    for sgn in (1, -1):
        c, s = cos, sgn * sin
        a00, a01, a10, a11 = c, -s, s, c
        t0 = cc - a00 * cc - a01 * cc
        t1 = cc - a10 * cc - a11 * cc
        mats.append([[a00, a01, t0], [a10, a11, t1]])
    exact = np.asarray(affine_resample(img, jnp.asarray(mats, jnp.float32), S))

    # compare interior region (borders differ: zero fill vs edge clamp)
    m = 12
    diff = np.abs(out3[:, m:-m, m:-m] - exact[:, m:-m, m:-m])
    assert diff.mean() < 2.0, diff.mean()
    assert np.corrcoef(out3[:, m:-m, m:-m].ravel(),
                       exact[:, m:-m, m:-m].ravel())[0, 1] > 0.995


def test_rotate_moves_content_directionally():
    S = 64
    img = np.zeros((1, S, S, 1), np.float32)
    img[0, 32, 48, 0] = 100.0  # point right of center
    out = np.asarray(rotate_batch(jnp.asarray(img),
                                  jnp.asarray([np.deg2rad(12.0)])))
    ys, xs, _ = np.nonzero(out[0] > 1.0)
    # out[i,j] = in[R(i,j)]: the point right of center appears below center
    # (inverse rotation of the sampling grid)
    assert ys.mean() > 32.5
    assert abs(xs.mean() - 48) < 4


def test_separable_resample_matches_gather_crop():
    rng = np.random.default_rng(1)
    img = jnp.asarray(rng.uniform(0, 255, (3, 64, 64, 3)).astype(np.float32))
    scale = jnp.asarray([0.9, 1.0, 0.8], jnp.float32)
    shift = jnp.asarray([2.0, 0.0, 5.0], jnp.float32)
    out = np.asarray(separable_resample(img, scale, shift, scale, shift, 48))

    mats = []
    for i in range(3):
        s, t = float(scale[i]), float(shift[i])
        mats.append([[s, 0, t], [0, s, t]])
    exact = np.asarray(affine_resample(img, jnp.asarray(mats, jnp.float32), 48))
    np.testing.assert_allclose(out, exact, atol=0.5)


def test_separable_identity():
    rng = np.random.default_rng(2)
    img = jnp.asarray(rng.uniform(0, 255, (1, 32, 32, 3)).astype(np.float32))
    one = jnp.ones((1,), jnp.float32)
    zero = jnp.zeros((1,), jnp.float32)
    out = separable_resample(img, one, zero, one, zero, 32)
    np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-3)
