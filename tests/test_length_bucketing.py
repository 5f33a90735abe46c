"""Predictor sequence-length bucketing: numerics must be identical.

The predictor serves each batch at the smallest length bucket that holds
its longest text (inference/predictor.py:_prep_texts) instead of the
reference's fixed pad-to-max (`src/predict.py:111-118`). Masked attention
makes real-token outputs bit-identical regardless of trailing pad count;
these tests pin that equivalence end-to-end through the JSON contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_rare_disease.config import resolve_config
from multimodal_rare_disease.data.tokenizer import get_tokenizer
from multimodal_rare_disease.inference.predictor import (
    MultimodalPredictor,
)
from multimodal_rare_disease.models import create_model

pytestmark = pytest.mark.smoke

# Tokenises to 13 tokens with the vocabulary built from the built-in
# syndrome descriptions (the tokenizer used when no corpus is present).
SHORT_TEXT = "Facial dysmorphism assessment reveals: long face, hooded eyelids."


def _make_predictor(length_bucketing, attend_over_tokens=False):
    cfg = resolve_config(overrides={
        "data.image_size": 64,
        "data.max_text_length": 64,
        "text_encoder.num_layers": 2,
        "text_encoder.num_heads": 2,
        "text_encoder.hidden_size": 32,
        "text_encoder.intermediate_size": 64,
        "text_encoder.vocab_size": 8192,
        "text_encoder.max_length": 64,
        "fusion.text_proj_dim": 32,
        "fusion.hidden_dim": 32,
        "fusion.num_attention_heads": 2,
        "cnn_encoder.embedding_dim": 32,
        "classifier.hidden_dims": (32,),
        "training.compute_dtype": "float32",
    })
    model = create_model(cfg, mode="multimodal",
                         attend_over_tokens=attend_over_tokens)
    v = model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                   jnp.zeros((1, 64), jnp.int32),
                   jnp.ones((1, 64), jnp.int32), train=False)
    return MultimodalPredictor(cfg, v["params"], v.get("batch_stats", {}),
                               mode="multimodal", tokenizer=get_tokenizer(),
                               length_bucketing=length_bucketing)


def test_bucket_selection_slices_to_smallest_fit():
    pred = _make_predictor(True)
    ids, mask = pred._prep_texts([SHORT_TEXT], 1)
    n_real = int(mask.sum())
    assert n_real < 32, "fixture text must fit the smallest bucket"
    assert ids.shape[1] == 32 and mask.shape[1] == 32


def test_long_text_stays_at_max_length():
    pred = _make_predictor(True)
    ids, mask = pred._prep_texts([SHORT_TEXT * 10], 1)
    assert ids.shape[1] == 64  # truncation bound unchanged


def test_bucketing_off_pads_to_max():
    pred = _make_predictor(False)
    ids, _ = pred._prep_texts([SHORT_TEXT], 1)
    assert ids.shape[1] == 64


@pytest.mark.parametrize("attend_over_tokens", [False, True])
def test_bucketed_probabilities_identical(attend_over_tokens):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    texts = [SHORT_TEXT, "Short stature and broad thumbs."]

    bucketed = _make_predictor(True, attend_over_tokens)
    full = MultimodalPredictor(
        bucketed.cfg, bucketed.params, bucketed.batch_stats,
        mode="multimodal", tokenizer=bucketed.tokenizer,
        length_bucketing=False)
    full.model = bucketed.model  # same weights, same module

    got = bucketed.predict_batch([img, img], texts)
    want = full.predict_batch([img, img], texts)
    for g, w in zip(got, want):
        g_probs = np.array(list(g["all_probabilities"].values()))
        w_probs = np.array(list(w["all_probabilities"].values()))
        np.testing.assert_allclose(g_probs, w_probs, rtol=0, atol=1e-6)
        assert g["top_prediction"]["class_id"] == \
            w["top_prediction"]["class_id"]
