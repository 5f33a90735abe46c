"""The in-repo module layer (multimodal_rare_disease/nn.py) against
flax.linen, where flax is installed: same parameter paths, shapes and
initial values from the same key, and the same outputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_rare_disease import nn as mnn


def _composite(nn):
    """Compact auto-names, explicit names, setup attributes (incl. a
    list), BatchNorm statistics, dropout RNG and a second method."""

    class Block(nn.Module):
        width: int

        @nn.compact
        def __call__(self, x, train):
            x = nn.Dense(self.width)(x)
            x = nn.LayerNorm()(x)
            x = nn.Dropout(0.5)(x, deterministic=not train)
            x = nn.Dense(self.width)(x)
            return nn.Dense(self.width, name="out")(nn.relu(x))

    class Net(nn.Module):
        def setup(self):
            self.blocks = [Block(8), Block(8)]
            self.bn = nn.BatchNorm(momentum=0.9)
            self.head = nn.Dense(3)

        def __call__(self, x, train=False):
            for block in self.blocks:
                x = block(x, train)
            return self.head(self.bn(x, use_running_average=not train))

        def first_block(self, x):
            return self.blocks[0](x, False)

    return Net()


_I32 = "int32"
# name -> (module builder over a namespace, input shape, input kind)
CASES = {
    "dense": (lambda nn: nn.Dense(7), (2, 5), "f32"),
    "dense_bf16": (lambda nn: nn.Dense(7, dtype=jnp.bfloat16), (2, 3, 5),
                   "f32"),
    "dense_general_heads": (
        lambda nn: nn.DenseGeneral((3, 4), axis=-1), (2, 6, 8), "f32"),
    "dense_general_contract_two": (
        lambda nn: nn.DenseGeneral(5, axis=(-2, -1)), (2, 3, 4), "f32"),
    "conv_same_strided": (
        lambda nn: nn.Conv(6, (3, 3), strides=(2, 2)), (2, 9, 9, 4), "f32"),
    "conv_padded_no_bias": (
        lambda nn: nn.Conv(6, (5, 5), padding=[(2, 2), (1, 3)],
                           use_bias=False), (2, 8, 8, 3), "f32"),
    "conv_depthwise_valid": (
        lambda nn: nn.Conv(8, (3, 3), padding="VALID",
                           feature_group_count=8), (2, 7, 7, 8), "f32"),
    "conv_transpose": (
        lambda nn: nn.ConvTranspose(3, (4, 4), strides=(2, 2)),
        (2, 5, 5, 6), "f32"),
    "batchnorm_running": (
        lambda nn: nn.BatchNorm(use_running_average=True, momentum=0.9,
                                epsilon=1e-5, dtype=jnp.bfloat16),
        (4, 3, 3, 5), "f32"),
    "layernorm": (lambda nn: nn.LayerNorm(epsilon=1e-12), (2, 3, 16),
                  "f32"),
    "embed": (lambda nn: nn.Embed(11, 6), (2, 5), _I32),
    "composite": (_composite, (4, 6), "f32"),
}


def _input(shape, kind):
    rng = np.random.default_rng(0)
    if kind == _I32:
        return jnp.asarray(rng.integers(0, 11, shape), jnp.int32)
    return jnp.asarray(rng.normal(size=shape), jnp.float32)


def _assert_trees_close(a, b, atol):
    assert (jax.tree_util.tree_structure(a)
            == jax.tree_util.tree_structure(b))
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_allclose(np.asarray(x, np.float32),
                                   np.asarray(y, np.float32), atol=atol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_flax(case):
    flax_nn = pytest.importorskip("flax.linen")
    build, shape, kind = CASES[case]
    x = _input(shape, kind)
    key = jax.random.key(3)
    ours, ref = build(mnn), build(flax_nn)

    v_ours = ours.init(key, x)
    v_ref = ref.init(key, x)
    _assert_trees_close(v_ours, v_ref, atol=0.0)

    atol = 2e-2 if "bf16" in case else 1e-5
    _assert_trees_close(ours.apply(v_ours, x), ref.apply(v_ref, x), atol)
    if case == "composite":
        train = dict(train=True, rngs={"dropout": jax.random.key(5)},
                     mutable=["batch_stats"])
        _assert_trees_close(ours.apply(v_ours, x, **train),
                            ref.apply(v_ref, x, **train), 1e-5)
        _assert_trees_close(
            ours.apply(v_ours, x, method="first_block"),
            ref.apply(v_ref, x, method=type(ref).first_block), 1e-5)


def test_max_pool_matches_flax():
    flax_nn = pytest.importorskip("flax.linen")
    x = _input((2, 7, 7, 3), "f32")
    for kw in ({"strides": (2, 2), "padding": [(1, 1), (1, 1)]},
               {"strides": (2, 2), "padding": [(0, 1), (0, 1)]},
               {}):
        np.testing.assert_array_equal(mnn.max_pool(x, (3, 3), **kw),
                                      flax_nn.max_pool(x, (3, 3), **kw))


def test_unbound_module_and_missing_param_raise():
    layer = mnn.Dense(3)
    with pytest.raises(ValueError, match="not bound"):
        layer(jnp.ones((1, 2)))
    with pytest.raises(KeyError, match="kernel"):
        layer.apply({"params": {}}, jnp.ones((1, 2)))
    bn = mnn.BatchNorm(use_running_average=False)
    v = bn.init(jax.random.key(0), jnp.ones((2, 3)))
    with pytest.raises(ValueError, match="not mutable"):
        bn.apply(v, jnp.ones((2, 3)))


def test_pytree_node_jits_and_replaces():
    class State(mnn.PyTreeNode):
        x: jnp.ndarray
        scale: float = mnn.static_field(default=2.0)

    s = State(jnp.ones(3))
    assert jax.tree_util.tree_leaves(s)[0].shape == (3,)
    out = jax.jit(lambda st: st.replace(x=st.x * st.scale))(s)
    np.testing.assert_array_equal(out.x, 2 * np.ones(3))
    assert out.scale == 2.0
