"""FGDD multimodal cycle-pairing (ref `src/train.py:797-811`)."""

from pathlib import Path

import numpy as np
import pytest

from multimodal_rare_disease.config import resolve_config
from multimodal_rare_disease.train.text_pipeline import (
    fgdd_multimodal_pipeline,
)

FGDD = Path("/root/reference/data/FGDD")
REF_IMAGES = Path("/root/reference/data/images")


def _cfg(**extra):
    over = {
        "data.image_size": 64,
        "data.max_text_length": 32,
        "data.augmentation_factor": 1,
        "text_encoder.num_layers": 2,
        "text_encoder.num_heads": 2,
        "text_encoder.hidden_size": 32,
        "text_encoder.intermediate_size": 64,
        "text_encoder.vocab_size": 8192,
        "text_encoder.max_length": 32,
        "fusion.text_proj_dim": 32,
        "fusion.hidden_dim": 32,
        "fusion.num_attention_heads": 2,
        "cnn_encoder.embedding_dim": 32,
        "classifier.hidden_dims": (32,),
        "training.batch_size": 8,
        "training.compute_dtype": "float32",
    }
    over.update(extra)
    return resolve_config(overrides=over)


@pytest.fixture(scope="module")
def pipe():
    if not FGDD.exists() or not REF_IMAGES.exists():
        pytest.skip("FGDD corpus / reference images not available")
    return fgdd_multimodal_pipeline(_cfg())


def test_pairing_cycles_texts_with_image_labels(pipe):
    n = pipe.fgdd_n_texts
    assert n > 100  # 1,147 FGDD patients → top-10 disease subset

    # labels come from images (10 syndromes), not FGDD diseases
    assert set(np.unique(pipe.train_labels)) <= set(range(10))

    batch = next(iter(pipe.train_index_batches()))
    assert set(batch) == {"rows", "levels", "variants"}
    assert (batch["levels"] == 0).all()
    assert (batch["variants"] < n).all()

    vb = next(iter(pipe.val_index_batches(batch_size=4)))
    assert set(vb) == {"rows", "valid", "levels", "variants"}

    # host path: per-sample texts attached, shapes static
    hb = next(iter(pipe.train_batches()))
    assert hb["input_ids"].shape == (8, 32)
    assert hb["images"].shape[0] == 8

    # device corpus carries the per-sample pool (class axis broadcast)
    corpus = pipe.device_corpus()
    assert corpus["pool_ids"].shape == (10, 1, n, 32)
    np.testing.assert_array_equal(corpus["pool_ids"][0], corpus["pool_ids"][5])


@pytest.mark.slow
def test_fgdd_multimodal_smoke_train(pipe, tmp_path):
    from multimodal_rare_disease.train import Trainer

    cfg = _cfg(**{"training.num_epochs": 1})
    trainer = Trainer(cfg, mode="multimodal", pipeline=pipe,
                      workdir=str(tmp_path))
    result = trainer.train(num_epochs=1)
    assert len(result["history"]["train_loss"]) == 1
    assert np.isfinite(result["history"]["train_loss"][0])
