"""Offline corpus tools: synthetic generator, augmenter, reorganizer
(host-only, fast)."""

import numpy as np
import pytest
from PIL import Image

from multimodal_rare_disease.config import SYNDROME_NAMES
from multimodal_rare_disease.data.images import scan_image_corpus
from multimodal_rare_disease.data.offline_augment import (
    AUGMENTATION_TYPES,
    augment_image,
    generate_augmented_dataset,
    reorganize_images,
)
from multimodal_rare_disease.data.synthetic import (
    SyntheticImageGenerator,
    generate_synthetic_for_training,
)


def test_synthetic_generator_deterministic_and_class_conditional():
    gen = SyntheticImageGenerator(image_size=64, seed=7)
    a1 = gen.generate(0, 0)
    a2 = gen.generate(0, 0)
    b = gen.generate(1, 0)
    c = gen.generate(0, 1)
    np.testing.assert_array_equal(a1, a2)
    assert a1.shape == (64, 64, 3) and a1.dtype == np.uint8
    assert np.abs(a1.astype(int) - b.astype(int)).mean() > 5  # classes differ
    assert np.abs(a1.astype(int) - c.astype(int)).mean() > 1  # samples differ


def test_synthetic_dataset_layouts(tmp_path):
    flat = tmp_path / "flat"
    generate_synthetic_for_training(flat, num_per_class=2, image_size=32)
    samples = scan_image_corpus(flat)
    assert len(samples) == 20
    assert {s.syndrome for s in samples} == set(SYNDROME_NAMES)

    gen = SyntheticImageGenerator(32)
    foldered = tmp_path / "foldered"
    gen.generate_dataset(foldered, num_per_class=1, flat=False)
    samples2 = scan_image_corpus(foldered)
    assert len(samples2) == 10


def test_augment_types_all_run(tmp_path):
    im = Image.fromarray(
        np.random.default_rng(0).integers(0, 255, (64, 64, 3),
                                          dtype=np.uint8))
    rng = np.random.default_rng(1)
    for name in AUGMENTATION_TYPES:
        out = augment_image(im, name, rng)
        assert out.size == (64, 64), name
    with pytest.raises(KeyError):
        augment_image(im, "nope", rng)


def test_generate_augmented_dataset_expansion(tmp_path):
    src = tmp_path / "src"
    generate_synthetic_for_training(src, num_per_class=1, image_size=32)
    out = tmp_path / "aug"
    counts = generate_augmented_dataset(src, out, augmentations_per_image=4)
    assert counts == {"original": 10, "augmented": 40}
    samples = scan_image_corpus(out)
    assert len(samples) == 50
    # naming convention feeds the leakage-aware split
    bases = {s.base_id for s in samples}
    assert len(bases) == 10
    # deterministic: rerun produces identical bytes
    out2 = tmp_path / "aug2"
    generate_augmented_dataset(src, out2, augmentations_per_image=4)
    f1 = sorted(p for p in out.rglob("*_aug00.png"))[0]
    f2 = sorted(p for p in out2.rglob("*_aug00.png"))[0]
    assert f1.read_bytes() == f2.read_bytes()


def test_reorganize_images(tmp_path):
    src = tmp_path / "src"
    generate_synthetic_for_training(src, num_per_class=2, image_size=32)
    out = tmp_path / "organized"
    counts = reorganize_images(src, out)
    assert sum(counts.values()) == 20
    assert (out / "Angelman_Syndrome").is_dir()
    samples = scan_image_corpus(out)
    assert len(samples) == 20


def test_cli_arg_errors():
    """Fast argparse error-path coverage (no jax compute)."""
    import pytest

    from multimodal_rare_disease.cli import stats as stats_cli

    with pytest.raises(SystemExit):
        from multimodal_rare_disease.cli.train import main as train_main

        train_main(["--mode", "bogus"])
    rc = stats_cli.main(["--results-dir", "/nonexistent/place"])
    assert rc == 1
