"""Shape-contract tests mirroring the reference's module self-tests
(image [B,H,W,3]→[B,512], text [B,T]→[B,768], fusion (512,768)→512,
logits [B,10]) — SURVEY.md §4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_rare_disease.config import resolve_config
from multimodal_rare_disease.models import (
    AttentionFusion,
    ClassificationHead,
    ConcatenationFusion,
    GatedFusion,
    create_cnn_encoder,
    create_model,
    create_text_encoder,
)


def tiny_cfg(**over):
    """Reduced dims so CPU tests stay fast; contracts unchanged."""
    base = {
        "text_encoder.num_layers": 2,
        "text_encoder.num_heads": 4,
        "text_encoder.hidden_size": 64,
        "text_encoder.intermediate_size": 128,
        "text_encoder.vocab_size": 200,
        "text_encoder.embedding_dim": 64,
        "fusion.text_proj_dim": 64,
        "fusion.hidden_dim": 32,
        "fusion.num_attention_heads": 4,
        "fusion.image_proj_dim": 16,
        "cnn_encoder.embedding_dim": 16,
        "data.max_text_length": 16,
        "text_encoder.max_length": 16,
    }
    base.update(over)
    return resolve_config("default", base)


@pytest.mark.parametrize("backbone,featdim", [("resnet50", 2048),
                                              ("efficientnet_b0", 1280)])
def test_cnn_encoder_contract(backbone, featdim):
    cfg = tiny_cfg(**{"cnn_encoder.backbone": backbone})
    enc = create_cnn_encoder(cfg.cnn_encoder)
    x = jnp.zeros((2, 64, 64, 3), jnp.float32)
    variables = enc.init(jax.random.key(0), x)
    emb, feats = enc.apply(variables, x, return_features=True)
    assert emb.shape == (2, 16)
    last = feats["stage4"] if backbone == "resnet50" else feats["head"]
    assert last.shape[0] == 2 and last.shape[-1] == featdim
    # stride: 64 / 32 = 2
    assert last.shape[1] == 2


def test_text_encoder_contract():
    cfg = tiny_cfg()
    enc = create_text_encoder(cfg.text_encoder)
    ids = jnp.ones((2, 16), jnp.int32)
    mask = jnp.ones((2, 16), jnp.int32)
    variables = enc.init(jax.random.key(0), ids, mask)
    emb = enc.apply(variables, ids, mask)
    assert emb.shape == (2, 64)
    emb2, out = enc.apply(variables, ids, mask, output_attentions=True,
                          output_hidden_states=True)
    assert len(out["attentions"]) == 2
    assert out["attentions"][0].shape == (2, 4, 16, 16)
    assert len(out["hidden_states"]) == 3


def test_text_encoder_mask_ignores_padding():
    """Padded positions must not influence the CLS embedding."""
    cfg = tiny_cfg()
    enc = create_text_encoder(cfg.text_encoder)
    ids = np.ones((1, 16), np.int32)
    mask = np.concatenate([np.ones((1, 8)), np.zeros((1, 8))], 1).astype(np.int32)
    variables = enc.init(jax.random.key(0), jnp.asarray(ids), jnp.asarray(mask))
    e1 = enc.apply(variables, jnp.asarray(ids), jnp.asarray(mask))
    ids2 = ids.copy()
    ids2[0, 8:] = 5  # garbage under the padding mask
    e2 = enc.apply(variables, jnp.asarray(ids2), jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(e1), np.asarray(e2), atol=1e-5)


@pytest.mark.parametrize("fusion_cls", [ConcatenationFusion, AttentionFusion,
                                        GatedFusion])
def test_fusion_contract(fusion_cls):
    fusion = fusion_cls(hidden_dim=32)
    img = jnp.ones((2, 16))
    txt = jnp.ones((2, 64))
    variables = fusion.init(jax.random.key(0), img, txt)
    fused, info = fusion.apply(variables, img, txt)
    assert fused.shape == (2, 32)
    if fusion_cls is AttentionFusion:
        # pooled-mode parity: softmax over a single key → weights all 1.0
        w = info["image_to_text_attention"]
        np.testing.assert_allclose(np.asarray(w), 1.0, atol=1e-6)


def test_attention_fusion_over_tokens():
    fusion = AttentionFusion(hidden_dim=32, attend_over_tokens=True)
    img, txt = jnp.ones((2, 16)), jnp.ones((2, 64))
    tokens = jax.random.normal(jax.random.key(1), (2, 16, 64))
    mask = jnp.ones((2, 16), jnp.int32)
    variables = fusion.init(jax.random.key(0), img, txt, text_tokens=tokens,
                            text_mask=mask)
    fused, info = fusion.apply(variables, img, txt, text_tokens=tokens,
                               text_mask=mask)
    assert fused.shape == (2, 32)
    w = np.asarray(info["image_to_text_attention"])
    assert w.shape == (2, 8, 1, 16)
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-5)
    assert w.std() > 1e-6  # actual attention content, not degenerate 1.0


def test_classification_head():
    head = ClassificationHead(hidden_dims=(256, 128), num_classes=10)
    x = jnp.ones((4, 512))
    variables = head.init(jax.random.key(0), x)
    logits = head.apply(variables, x)
    assert logits.shape == (4, 10)
    assert logits.dtype == jnp.float32


@pytest.mark.parametrize("mode", ["multimodal", "image_only", "text_only"])
def test_assembled_models(mode):
    cfg = tiny_cfg()
    model = create_model(cfg, mode=mode, dtype=jnp.float32)
    images = jnp.zeros((2, 64, 64, 3))
    ids = jnp.ones((2, 16), jnp.int32)
    mask = jnp.ones((2, 16), jnp.int32)
    if mode == "multimodal":
        args = (images, ids, mask)
    elif mode == "image_only":
        args = (images,)
    else:
        args = (ids, mask)
    variables = model.init(jax.random.key(0), *args)
    out = model.apply(variables, *args)
    assert out["logits"].shape == (2, 10)
    np.testing.assert_allclose(np.asarray(out["probs"]).sum(-1), 1.0, atol=1e-5)


def test_multimodal_embeddings_and_attention():
    cfg = tiny_cfg()
    model = create_model(cfg, mode="multimodal", dtype=jnp.float32)
    images = jnp.zeros((2, 64, 64, 3))
    ids = jnp.ones((2, 16), jnp.int32)
    mask = jnp.ones((2, 16), jnp.int32)
    variables = model.init(jax.random.key(0), images, ids, mask)
    out = model.apply(variables, images, ids, mask,
                      return_embeddings=True, return_attention=True)
    assert out["image_embedding"].shape == (2, 16)
    assert out["text_embedding"].shape == (2, 64)
    assert out["fused_embedding"].shape == (2, 32)
    assert "image_to_text_attention" in out["attention_info"]


def test_train_mode_needs_dropout_rng_and_batchstats():
    cfg = tiny_cfg()
    model = create_model(cfg, mode="image_only", dtype=jnp.float32)
    images = jnp.zeros((2, 64, 64, 3))
    variables = model.init(jax.random.key(0), images, train=False)
    out, mutated = model.apply(
        variables, images, train=True,
        rngs={"dropout": jax.random.key(1)},
        mutable=["batch_stats"])
    assert out["logits"].shape == (2, 10)
    assert "batch_stats" in mutated


def test_gradcam_tail_vjp():
    """logits_from_image_features is differentiable w.r.t. the feature map."""
    cfg = tiny_cfg()
    model = create_model(cfg, mode="image_only", dtype=jnp.float32)
    images = jnp.zeros((1, 64, 64, 3))
    variables = model.init(jax.random.key(0), images)
    feats = model.apply(variables, images, method="image_feature_maps")
    fmap = feats["stage4"]

    def tail(fm):
        return model.apply(variables, fm, method="logits_from_image_features")

    logits, vjp = jax.vjp(tail, fmap)
    (grad,) = vjp(jax.nn.one_hot(jnp.array([3]), 10))
    assert grad.shape == fmap.shape
    assert np.isfinite(np.asarray(grad)).all()


def test_bert_cls_only_final_matches_full_forward():
    """The inference fast path (last layer computes only the CLS position)
    must be numerically identical to slicing the full forward at [:, 0]."""
    from multimodal_rare_disease.models.bert import BertEncoder

    enc = BertEncoder(vocab_size=128, hidden_size=32, num_layers=3,
                      num_heads=4, intermediate_size=64,
                      max_position_embeddings=64, dropout=0.0)
    rng = np.random.default_rng(0)
    ids = jnp.asarray(rng.integers(0, 128, (2, 16)), jnp.int32)
    mask = jnp.asarray([[1] * 12 + [0] * 4, [1] * 16], jnp.int32)
    params = enc.init(jax.random.key(0), ids, mask)["params"]

    full = enc.apply({"params": params}, ids, mask)
    fast = enc.apply({"params": params}, ids, mask, cls_only_final=True)
    assert fast["last_hidden_state"].shape == (2, 1, 32)
    np.testing.assert_allclose(np.asarray(fast["cls"]),
                               np.asarray(full["cls"]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(fast["pooler_output"]),
                               np.asarray(full["pooler_output"]), atol=1e-6)


def test_bert_flat_residual_stream_equals_classic():
    """flat_residual keeps the residual stream [B*T, H] between layers
    (unambiguous 2-D matmuls for XLA layout assignment). Pure reshapes: must be bit-exact vs
    the classic [B, T, H] stream, for both cls_only_final settings, and
    the viz path must still produce 3-D hidden states/attentions."""
    from multimodal_rare_disease.models.bert import BertEncoder

    kw = dict(vocab_size=128, hidden_size=32, num_layers=3, num_heads=4,
              intermediate_size=64, max_position_embeddings=64, dropout=0.0,
              )
    enc_f = BertEncoder(flat_residual=True, **kw)
    enc_c = BertEncoder(flat_residual=False, **kw)
    rng = np.random.default_rng(1)
    ids = jnp.asarray(rng.integers(0, 128, (2, 16)), jnp.int32)
    mask = jnp.asarray([[1] * 12 + [0] * 4, [1] * 16], jnp.int32)
    params = enc_f.init(jax.random.key(0), ids, mask)["params"]

    for cls_only in (False, True):
        of = enc_f.apply({"params": params}, ids, mask,
                         cls_only_final=cls_only)
        oc = enc_c.apply({"params": params}, ids, mask,
                         cls_only_final=cls_only)
        np.testing.assert_array_equal(np.asarray(of["cls"]),
                                      np.asarray(oc["cls"]))
        np.testing.assert_array_equal(np.asarray(of["pooler_output"]),
                                      np.asarray(oc["pooler_output"]))
        assert of["last_hidden_state"].shape == oc["last_hidden_state"].shape

    viz = enc_f.apply({"params": params}, ids, mask,
                      output_hidden_states=True, output_attentions=True)
    assert viz["hidden_states"][-1].shape == (2, 16, 32)
    assert viz["attentions"][0].shape == (2, 4, 16, 16)


def test_stem_conv_s2d_equals_canonical():
    """Inference space-to-depth stem must match the 7x7/s2 conv exactly."""
    from multimodal_rare_disease.models.resnet import _StemConv

    m = _StemConv()
    x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 64, 64, 3)),
                    jnp.float32)
    v = m.init(jax.random.key(0), x)
    a = m.apply(v, x, s2d=False)
    b = m.apply(v, x, s2d=True)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
    # odd sizes fall back to the canonical path
    xo = x[:, :63, :63, :]
    np.testing.assert_allclose(np.asarray(m.apply(v, xo, s2d=True)),
                               np.asarray(m.apply(v, xo, s2d=False)),
                               atol=1e-6)


def test_attention_lane_padding_is_exact():
    """T=96 inference pads the attention core to 128 internally; the
    result must be bit-identical to tokenizer-level padding to 128
    (the previous serving behavior for these texts)."""
    from multimodal_rare_disease.models.bert import BertEncoder

    B, H, heads = 3, 128, 2
    rng = np.random.default_rng(3)
    enc = BertEncoder(vocab_size=60, hidden_size=H, num_layers=2,
                      num_heads=heads, intermediate_size=256,
                      max_position_embeddings=256, dtype=jnp.float32)
    T = 96
    ids = np.asarray(rng.integers(1, 60, (B, T)), np.int32)
    lens = np.array([50, 96, 77])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    v = enc.init(jax.random.key(0), jnp.asarray(ids), jnp.asarray(mask))
    a = np.asarray(enc.apply(v, jnp.asarray(ids), jnp.asarray(mask))["cls"])

    ids128 = np.zeros((B, 128), np.int32)
    ids128[:, :T] = ids
    mask128 = np.zeros((B, 128), np.int32)
    mask128[:, :T] = mask
    b = np.asarray(enc.apply(v, jnp.asarray(ids128),
                             jnp.asarray(mask128))["cls"])
    np.testing.assert_array_equal(a, b)
