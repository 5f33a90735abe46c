from pathlib import Path

import numpy as np
import pytest

from multimodal_rare_disease.config import resolve_config, find_image_dir
from multimodal_rare_disease.data.images import (
    ImageSample,
    WeightedSampler,
    class_counts,
    class_weights,
    leakage_aware_split,
    load_corpus_arrays,
    ratio_split,
    scan_image_corpus,
    stratified_split,
)

REF_IMAGES = Path("/root/reference/data/images")


def _fake_samples(per_class=(5, 5, 2), augs=3):
    out = []
    for label, n in enumerate(per_class):
        for i in range(n):
            out.append(ImageSample(f"/x/c{label}/img{i}_orig.png", label, f"s{label}"))
            for a in range(augs):
                out.append(ImageSample(f"/x/c{label}/img{i}_aug{a:02d}.png",
                                       label, f"s{label}"))
    return out


@pytest.mark.skipif(not REF_IMAGES.is_dir(), reason="reference corpus absent")
def test_scan_flat_reference_corpus():
    samples = scan_image_corpus(REF_IMAGES)
    assert len(samples) == 50
    counts = class_counts(samples)
    np.testing.assert_array_equal(counts, np.full(10, 5))


@pytest.mark.skipif(not REF_IMAGES.is_dir(), reason="reference corpus absent")
def test_load_corpus_arrays_reference():
    samples = scan_image_corpus(REF_IMAGES)[:4]
    imgs, labels = load_corpus_arrays(samples, size=256)
    assert imgs.shape == (4, 256, 256, 3) and imgs.dtype == np.uint8
    assert labels.dtype == np.int32
    assert imgs.std() > 1  # actual image content


def test_scan_foldered_layout(tmp_path):
    from PIL import Image

    d = tmp_path / "Angelman_Syndrome"
    d.mkdir()
    Image.new("RGB", (16, 16)).save(d / "a.png")
    d2 = tmp_path / "SYN_KBG"
    d2.mkdir()
    Image.new("RGB", (16, 16)).save(d2 / "b.png")
    samples = scan_image_corpus(tmp_path)
    labels = {s.syndrome for s in samples}
    assert labels == {"Angelman Syndrome", "KBG Syndrome"}


def test_class_weights_inverse_frequency():
    samples = _fake_samples(per_class=(8, 4, 0), augs=0)
    w = class_weights(samples, num_classes=3)
    assert w[1] == pytest.approx(2 * w[0])
    assert w[2] == 0.0


def test_ratio_split_sizes():
    samples = _fake_samples(per_class=(20, 20), augs=0)
    tr, va, te = ratio_split(samples, 0.7, 0.15)
    assert len(tr) == 28 and len(va) == 6 and len(te) == 6
    assert {s.path for s in tr} | {s.path for s in va} | {s.path for s in te} \
        == {s.path for s in samples}


def test_stratified_split_min_val():
    samples = _fake_samples(per_class=(5, 5, 5), augs=0)
    tr, va = stratified_split(samples, val_fraction=0.15)
    for label in range(3):
        assert sum(1 for s in va if s.label == label) >= 1
        assert sum(1 for s in tr if s.label == label) >= 1


def test_leakage_aware_split_no_base_overlap():
    samples = _fake_samples(per_class=(5, 5, 2), augs=3)
    tr, va = leakage_aware_split(samples, val_fraction=0.2)
    tr_bases = {(s.label, s.base_id) for s in tr}
    va_bases = {(s.label, s.base_id) for s in va}
    assert tr_bases.isdisjoint(va_bases)
    assert len(tr) + len(va) == len(samples)
    # every augmented copy stays with its original
    for s in va:
        assert all(x.base_id != s.base_id or x in va
                   for x in samples if x.label == s.label)


def test_weighted_sampler_balances():
    samples = _fake_samples(per_class=(90, 10), augs=0)
    from multimodal_rare_disease.data.images import sample_weights

    w = sample_weights(samples, num_classes=2)
    sampler = WeightedSampler(w, num_samples=20000,
                              rng=np.random.default_rng(0))
    idx = sampler.sample_epoch()
    labels = np.array([samples[i].label for i in idx])
    frac1 = (labels == 1).mean()
    assert 0.45 < frac1 < 0.55  # balanced despite 90/10 skew


def test_corrupt_image_placeholder(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    from multimodal_rare_disease.data.images import load_image_uint8

    arr = load_image_uint8(str(bad), size=32)
    assert arr.shape == (32, 32, 3)
    assert (arr == 128).all()


def test_face_detector_hook(tmp_path):
    """Face-crop hook parity (ref FaceDetector, image_dataset_loader.py:27-77):
    registered detector crops with 20% margin; fallback is plain resize."""
    from PIL import Image

    from multimodal_rare_disease.data.images import (
        load_image_uint8,
        set_face_detector,
    )

    arr = np.zeros((100, 100, 3), np.uint8)
    arr[40:60, 40:60] = 255  # bright "face" square in the center
    p = tmp_path / "face.png"
    Image.fromarray(arr).save(p)

    # no detector: plain resize keeps dark borders
    plain = load_image_uint8(str(p), 50)
    assert plain[0, 0].max() == 0

    # detector returning the bright box: crop (with 20% margin) + resize
    set_face_detector(lambda a: (40, 40, 20, 20))
    try:
        cropped = load_image_uint8(str(p), 50)
    finally:
        set_face_detector(None)
    # the crop is 36x36 around the 20x20 bright square -> much brighter
    assert cropped.mean() > plain.mean() * 2

    # detector raising: graceful fallback to the resize path
    def boom(a):
        raise RuntimeError("no model")

    set_face_detector(boom)
    try:
        fb = load_image_uint8(str(p), 50)
    finally:
        set_face_detector(None)
    np.testing.assert_array_equal(fb, plain)
