"""Fast-tier (CPU) tests for the pre-LayerNorm model variant.

`text_encoder.pre_layernorm` is the from-scratch-trainability option
(GPT-2/ViT LN placement; the reference's HF BERT is post-LN,
`/root/reference/src/text_encoder.py:27-118`). These tests pin:

  * LN placement semantics: a BertLayer under each flag matches a
    hand-rolled reference built from the SAME extracted params — pre-LN
    is `x + attn(LN(x))` then `x + ffn(LN(x))`, post-LN is
    `LN(x + attn(x))` then `LN(x + ffn(x))`.
  * Param-tree relationship: the pre-LN encoder tree is exactly the
    post-LN tree plus the one `final_ln` module (so post-LN checkpoints
    are loadable into a pre-LN model modulo that single extra LN, and
    the flag being off cannot perturb goldens).
  * Config threading: `text_encoder.pre_layernorm` reaches the
    module through `create_text_encoder`.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from multimodal_rare_disease.models.bert import BertEncoder, BertLayer

pytestmark = pytest.mark.smoke

B, T, H, HEADS, F = 2, 8, 32, 2, 64
D = H // HEADS


def _init_layer(pre_ln: bool):
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=(B, T, H)) * 0.5, jnp.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, 5:] = 0
    bias = jnp.asarray((1.0 - mask[:, None, None, :]) * -1e9, jnp.float32)
    layer = BertLayer(H, HEADS, F, dropout=0.0, pre_ln=pre_ln, dtype=jnp.float32)
    variables = layer.init(jax.random.key(0), x, bias)
    return layer, variables, x, bias


def _ln(x, p):
    xf = x.astype(jnp.float32)
    mu = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.maximum(jnp.mean(jnp.square(xf), -1, keepdims=True)
                      - jnp.square(mu), 0.0)
    return (xf - mu) * jax.lax.rsqrt(var + 1e-12) * p["scale"] + p["bias"]


def _attn(x, p):
    qkv = jnp.einsum("bth,hcnd->btcnd", x, p["qkv"]["kernel"]) \
        + p["qkv"]["bias"]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return q, k, v


def _attention(x, p, att_bias):
    q, k, v = _attn(x, p)
    scores = jnp.einsum("bthd,bshd->bhts", q, k) / np.sqrt(D) + att_bias
    probs = jax.nn.softmax(scores, axis=-1)
    ctx = jnp.einsum("bhts,bshd->bthd", probs, v)
    return jnp.einsum("bthd,hdo->bto", ctx, p["output"]["kernel"]) \
        + p["output"]["bias"]


def _ffn(x, p):
    h = jnp.dot(x, p["intermediate"]["kernel"]) + p["intermediate"]["bias"]
    h = 0.5 * h * (1.0 + jax.lax.erf(h / np.sqrt(2.0)))
    return jnp.dot(h, p["output"]["kernel"]) + p["output"]["bias"]


def test_pre_ln_layer_matches_hand_reference():
    layer, variables, x, bias = _init_layer(pre_ln=True)
    got, _ = layer.apply(variables, x, bias, train=False)
    p = variables["params"]
    h = x + _attention(_ln(x, p["attention_ln"]), p["attention"], bias)
    want = h + _ffn(_ln(h, p["output_ln"]), p)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


def test_post_ln_layer_matches_hand_reference():
    layer, variables, x, bias = _init_layer(pre_ln=False)
    got, _ = layer.apply(variables, x, bias, train=False)
    p = variables["params"]
    h = _ln(x + _attention(x, p["attention"], bias), p["attention_ln"])
    want = _ln(h + _ffn(h, p), p["output_ln"])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


def test_pre_and_post_ln_layer_param_trees_identical():
    _, v_pre, _, _ = _init_layer(pre_ln=True)
    _, v_post, _, _ = _init_layer(pre_ln=False)
    assert jax.tree.structure(v_pre) == jax.tree.structure(v_post)
    for a, b in zip(jax.tree.leaves(v_pre), jax.tree.leaves(v_post)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_pre_ln_encoder_tree_is_post_ln_plus_final_ln():
    ids = jnp.zeros((B, T), jnp.int32)
    mask = jnp.ones((B, T), jnp.int32)
    kw = dict(vocab_size=50, hidden_size=H, num_layers=2, num_heads=HEADS,
              intermediate_size=F, max_position_embeddings=T,
              dtype=jnp.float32)
    v_post = BertEncoder(pre_ln=False, **kw).init(jax.random.key(0), ids, mask)
    v_pre = BertEncoder(pre_ln=True, **kw).init(jax.random.key(0), ids, mask)
    post_keys = set(v_post["params"])
    pre_keys = set(v_pre["params"])
    assert pre_keys - post_keys == {"final_ln"}
    assert post_keys - pre_keys == set()
    # every shared module's params line up (a post-LN checkpoint slots
    # into a pre-LN model modulo the one fresh final_ln)
    for k in post_keys:
        sa = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                          v_post["params"][k])
        sb = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                          v_pre["params"][k])
        assert sa == sb, k


def test_pre_ln_final_ln_applied_before_readout():
    """With pre_ln, `last_hidden_state` rows are LayerNorm outputs of
    the fresh final_ln (scale=1, bias=0) → per-row mean ~0, var ~1."""
    ids = jnp.zeros((B, T), jnp.int32)
    mask = jnp.ones((B, T), jnp.int32)
    enc = BertEncoder(vocab_size=50, hidden_size=H, num_layers=1,
                      num_heads=HEADS, intermediate_size=F,
                      max_position_embeddings=T, dropout=0.0,
                      pre_ln=True, dtype=jnp.float32)
    v = enc.init(jax.random.key(1), ids, mask)
    out = np.asarray(
        enc.apply(v, ids, mask, train=True)["last_hidden_state"])
    np.testing.assert_allclose(out.mean(axis=-1), 0.0, atol=1e-5)
    np.testing.assert_allclose(out.var(axis=-1), 1.0, atol=1e-3)


def test_pre_layernorm_flag_threads_from_config():
    from multimodal_rare_disease.config import resolve_config
    from multimodal_rare_disease.models.bert import create_text_encoder

    cfg_on = resolve_config("default", text_encoder__pre_layernorm=True)
    cfg_off = resolve_config("default")
    assert create_text_encoder(cfg_on.text_encoder).pre_ln is True
    assert create_text_encoder(cfg_off.text_encoder).pre_ln is False
