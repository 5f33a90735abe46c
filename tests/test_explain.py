"""Explainability tests: Grad-CAM localization + attention extraction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_rare_disease.data.tokenizer import (
    BertWordPieceTokenizer,
    build_wordpiece_vocab,
)
from multimodal_rare_disease.explain import (
    GradCAM,
    cross_modal_attention_summary,
    gradcam_heatmap,
    overlay_heatmap,
    text_token_attention,
)
from multimodal_rare_disease.models import create_model

from tests.test_trainer import small_cfg


@pytest.fixture(scope="module")
def image_model():
    cfg = small_cfg()
    model = create_model(cfg, mode="image_only", dtype=jnp.float32)
    variables = model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    return cfg, model, variables


def test_gradcam_shapes_and_range(image_model):
    cfg, model, variables = image_model
    gc = GradCAM(cfg, model, variables["params"],
                 variables.get("batch_stats", {}), mode="image_only")
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    cam, logits = gc(imgs)
    assert cam.shape[0] == 2 and cam.ndim == 3
    assert logits.shape == (2, 10)
    assert cam.min() >= 0.0 and cam.max() <= 1.0 + 1e-6
    # explicit class index
    cam2, _ = gc(imgs, class_idx=np.array([3, 7]))
    assert np.isfinite(cam2).all()


def test_gradcam_multimodal(trained_multimodal=None):
    cfg = small_cfg()
    model = create_model(cfg, mode="multimodal", dtype=jnp.float32)
    T = cfg.data.max_text_length
    variables = model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                           jnp.ones((1, T), jnp.int32),
                           jnp.ones((1, T), jnp.int32))
    gc = GradCAM(cfg, model, variables["params"],
                 variables.get("batch_stats", {}), mode="multimodal")
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)
    ids = np.ones((1, T), np.int32)
    mask = np.ones((1, T), np.int32)
    cam, logits = gc(imgs, ids, mask)
    assert cam.shape[0] == 1 and np.isfinite(cam).all()


def test_heatmap_upsample_and_overlay():
    cam = np.zeros((7, 7), np.float32)
    cam[3, 3] = 1.0
    big = gradcam_heatmap(cam, 224)
    assert big.shape == (224, 224)
    assert big.max() > 0.5
    img = np.full((224, 224, 3), 100, np.uint8)
    out = overlay_heatmap(img, big)
    assert out.shape == (224, 224, 3) and out.dtype == np.uint8
    # heated center differs from cold corner
    assert not np.array_equal(out[112, 112], out[0, 0])


def test_text_token_attention():
    cfg = small_cfg()
    corpus = ["synophrys and long eyelashes observed in patient",
              "wide mouth with full lips and periorbital fullness"]
    tok = BertWordPieceTokenizer(build_wordpiece_vocab(corpus))
    cfg2 = small_cfg(**{"text_encoder.vocab_size": tok.vocab_size})
    model = create_model(cfg2, mode="multimodal", dtype=jnp.float32)
    T = cfg2.data.max_text_length
    variables = model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                           jnp.ones((1, T), jnp.int32),
                           jnp.ones((1, T), jnp.int32))
    pairs = text_token_attention(cfg2, model, variables["params"],
                                 variables.get("batch_stats", {}),
                                 tok, "synophrys and wide mouth")
    assert len(pairs) >= 3
    total = sum(w for _, w in pairs)
    assert total == pytest.approx(1.0, abs=1e-5)
    assert all(w >= 0 for _, w in pairs)
    toks = [t for t, _ in pairs]
    assert "synophrys" in toks
    assert "[CLS]" not in toks and "[SEP]" not in toks


def test_cross_modal_summary(tmp_path):
    cfg = small_cfg()
    model = create_model(cfg, mode="multimodal", dtype=jnp.float32)
    T = cfg.data.max_text_length
    imgs = jnp.zeros((1, 64, 64, 3))
    ids = jnp.ones((1, T), jnp.int32)
    mask = jnp.ones((1, T), jnp.int32)
    variables = model.init(jax.random.key(0), imgs, ids, mask)
    out = model.apply(variables, imgs, ids, mask, return_attention=True)
    summary = cross_modal_attention_summary(out["attention_info"])
    assert summary["image_to_text"].shape[0] == cfg.fusion.num_attention_heads

    from multimodal_rare_disease.explain.attention import (
        plot_cross_modal_attention,
        plot_text_attention,
    )

    plot_cross_modal_attention(summary, tmp_path / "cm.png")
    plot_text_attention([("a", 0.6), ("b", 0.4)], tmp_path / "ta.png")
    assert (tmp_path / "cm.png").exists()
    assert (tmp_path / "ta.png").exists()
