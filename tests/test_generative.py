"""Learned synthetic backend (class-conditional conv VAE).

Honest-capability counterpart to the procedural generator: the reference
wraps an unshipped StyleGAN3 pickle (`src/synthetic_image_generator.py`);
here a small VAE trained on the corpus provides a real learned
class-conditional generator behind the same API.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # 150-epoch VAE training: ~2 min on 1 vCPU

from multimodal_rare_disease.data.generative import (
    ConvVAE,
    VAEImageGenerator,
    train_vae,
)


@pytest.fixture(scope="module")
def trained():
    rng = np.random.default_rng(0)
    # 2 images per class, each class with a distinct mean color so the
    # conditional decoder has something learnable
    means = rng.uniform(40, 220, (10, 3))
    imgs = np.clip(means[np.repeat(np.arange(10), 2)][:, None, None, :]
                   + rng.normal(0, 10, (20, 64, 64, 3)), 0, 255
                   ).astype(np.uint8)
    labels = np.repeat(np.arange(10), 2)
    model, params, loss = train_vae(imgs, labels, num_epochs=150, seed=1)
    return model, params, loss, means


def test_vae_trains_and_loss_decreases(trained):
    model, params, loss, _ = trained
    # untrained reconstruction error for 64x64x3 images ~ sum of squares
    # >> a few hundred; trained should be well below the flat-gray bound
    assert np.isfinite(loss)
    assert loss < 3000.0


def test_vae_generator_api_and_class_conditioning(trained, tmp_path):
    model, params, _, means = trained
    gen = VAEImageGenerator(model, params, image_size=64, seed=3)

    a = gen.generate(0, 0)
    b = gen.generate(5, 0)
    assert a.shape == (64, 64, 3) and a.dtype == np.uint8
    # class conditioning: generated class means track the training class
    # colors better than a cross pairing
    err_match = (np.abs(a.mean((0, 1)) - means[0]).mean()
                 + np.abs(b.mean((0, 1)) - means[5]).mean())
    err_cross = (np.abs(a.mean((0, 1)) - means[5]).mean()
                 + np.abs(b.mean((0, 1)) - means[0]).mean())
    assert err_match < err_cross

    written = gen.generate_dataset(tmp_path, num_per_class=1)
    assert sum(len(v) for v in written.values()) == 10
    # corpus layout understood by the loaders
    from multimodal_rare_disease.data.images import scan_image_corpus

    samples = list(scan_image_corpus(tmp_path))
    assert len(samples) == 10


def test_vae_determinism(trained):
    model, params, _, _ = trained
    gen = VAEImageGenerator(model, params, image_size=64, seed=9)
    x1 = gen.generate(2, 7)
    x2 = gen.generate(2, 7)
    np.testing.assert_array_equal(x1, x2)
