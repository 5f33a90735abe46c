"""Int8 W8A8 serving path: numerics vs the f32/bf16 path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_rare_disease.models.bert import BertEncoder
from multimodal_rare_disease.models.quant import (
    MaybeQuantDenseGeneral,
    int8_matmul,
)


def test_int8_matmul_accuracy():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 256)).astype(np.float32)
    w = rng.normal(size=(256, 128)).astype(np.float32) * 0.05
    ref = x @ w
    got = np.asarray(int8_matmul(jnp.asarray(x), jnp.asarray(w)))
    rel = np.abs(got - ref).mean() / np.abs(ref).mean()
    assert rel < 0.02, rel


def test_maybe_quant_dense_param_compat():
    """Param tree must be identical to nn.DenseGeneral's so checkpoints
    interchange between the bf16 and int8 paths."""
    from multimodal_rare_disease import nn

    x = jnp.ones((2, 8, 32))
    ref_mod = nn.DenseGeneral((3, 4, 8), axis=-1)
    ref_shapes = jax.tree_util.tree_map(
        lambda a: a.shape, ref_mod.init(jax.random.key(0), x)["params"])
    q_mod = MaybeQuantDenseGeneral((3, 4, 8), axis=-1, quantized=True)
    q_shapes = jax.tree_util.tree_map(
        lambda a: a.shape, q_mod.init(jax.random.key(0), x)["params"])
    assert ref_shapes == q_shapes

    # axis=(-2,-1) layout
    x2 = jnp.ones((2, 8, 4, 8))
    ref2 = jax.tree_util.tree_map(
        lambda a: a.shape,
        nn.DenseGeneral(32, axis=(-2, -1)).init(jax.random.key(0), x2)["params"])
    got2 = jax.tree_util.tree_map(
        lambda a: a.shape,
        MaybeQuantDenseGeneral(32, axis=(-2, -1)).init(
            jax.random.key(0), x2)["params"])
    assert ref2 == got2


def test_maybe_quant_dense_matches_dense_when_off():
    from multimodal_rare_disease import nn

    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 8, 32)), jnp.float32)
    mod = MaybeQuantDenseGeneral(16, quantized=False)
    variables = mod.init(jax.random.key(0), x)
    ref = nn.DenseGeneral(16).apply(variables, x)
    got = mod.apply(variables, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_bert_quantized_close_to_f32():
    ids = jnp.asarray(np.random.default_rng(2).integers(0, 100, (2, 32)),
                      jnp.int32)
    mask = jnp.ones((2, 32), jnp.int32)
    kw = dict(vocab_size=100, hidden_size=64, num_layers=2, num_heads=4,
              intermediate_size=128, dropout=0.0, )
    enc_f = BertEncoder(quantized=False, **kw)
    enc_q = BertEncoder(quantized=True, **kw)
    variables = enc_f.init(jax.random.key(0), ids, mask)
    out_f = np.asarray(enc_f.apply(variables, ids, mask)["cls"])
    out_q = np.asarray(enc_q.apply(variables, ids, mask)["cls"])
    cos = (out_f * out_q).sum() / (np.linalg.norm(out_f)
                                   * np.linalg.norm(out_q))
    assert cos > 0.999, cos


def test_quantized_training_path_unaffected():
    """quantized=True must still use full precision under train=True and
    remain differentiable."""
    ids = jnp.ones((1, 8), jnp.int32)
    mask = jnp.ones((1, 8), jnp.int32)
    enc = BertEncoder(vocab_size=50, hidden_size=32, num_layers=1,
                      num_heads=2, intermediate_size=64, dropout=0.0,
                      quantized=True, )
    variables = enc.init(jax.random.key(0), ids, mask)

    def loss(params):
        out = enc.apply({"params": params}, ids, mask, train=True,
                        rngs={"dropout": jax.random.key(1)})
        return jnp.sum(out["cls"] ** 2)

    from jax.flatten_util import ravel_pytree

    g = jax.grad(loss)(variables["params"])
    flat = ravel_pytree(g)[0]
    assert np.isfinite(np.asarray(flat)).all()
    assert np.abs(np.asarray(flat)).max() > 0
