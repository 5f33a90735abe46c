"""Weight-conversion numerics tests.

The HF parity test builds a LOCAL random-initialized `BertModel` (no
network) and checks our converted encoder reproduces its hidden states —
the same code path a real offline BioBERT checkpoint would take.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")


def _small_hf_config():
    from transformers import BertConfig

    return BertConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    )


def test_hf_bert_conversion_numerics():
    from transformers import BertModel

    from multimodal_rare_disease.models.bert import BertEncoder
    from multimodal_rare_disease.models.convert import convert_hf_bert

    hf_cfg = _small_hf_config()
    torch.manual_seed(0)
    hf = BertModel(hf_cfg).eval()

    ids = np.array([[2, 5, 9, 11, 3, 0, 0, 0]], np.int64)
    mask = np.array([[1, 1, 1, 1, 1, 0, 0, 0]], np.int64)
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids),
                 attention_mask=torch.tensor(mask))
    ref_hidden = ref.last_hidden_state.numpy()
    ref_pooled = ref.pooler_output.numpy()

    params = convert_hf_bert(hf.state_dict(), num_layers=2, num_heads=4)
    enc = BertEncoder(vocab_size=128, hidden_size=32, num_layers=2,
                      num_heads=4, intermediate_size=64,
                      max_position_embeddings=64, dropout=0.0)
    out = enc.apply({"params": params}, jnp.asarray(ids, jnp.int32),
                    jnp.asarray(mask, jnp.int32))

    np.testing.assert_allclose(np.asarray(out["last_hidden_state"]),
                               ref_hidden, atol=2e-5)
    np.testing.assert_allclose(np.asarray(out["pooler_output"]),
                               ref_pooled, atol=2e-5)


def test_resnet_conversion_structure_and_numerics():
    """Synthetic torchvision-style state_dict → our encoder; verify the
    stem conv+bn numerics against torch ops."""
    import torch.nn.functional as F

    from multimodal_rare_disease.models.convert import (
        convert_torchvision_resnet50,
    )
    from multimodal_rare_disease.models.resnet import ResNet50Encoder

    torch.manual_seed(0)
    sd = {}

    def add_conv(name, o, i, k):
        sd[f"{name}.weight"] = torch.randn(o, i, k, k) * 0.05

    def add_bn(name, c):
        sd[f"{name}.weight"] = torch.rand(c) + 0.5
        sd[f"{name}.bias"] = torch.randn(c) * 0.1
        sd[f"{name}.running_mean"] = torch.randn(c) * 0.1
        sd[f"{name}.running_var"] = torch.rand(c) + 0.5

    add_conv("conv1", 64, 3, 7)
    add_bn("bn1", 64)
    widths = (64, 128, 256, 512)
    for stage, (n, w) in enumerate(zip((3, 4, 6, 3), widths), start=1):
        in_ch = 64 if stage == 1 else widths[stage - 2] * 4
        for b in range(n):
            base = f"layer{stage}.{b}"
            cin = in_ch if b == 0 else w * 4
            add_conv(f"{base}.conv1", w, cin, 1)
            add_bn(f"{base}.bn1", w)
            add_conv(f"{base}.conv2", w, w, 3)
            add_bn(f"{base}.bn2", w)
            add_conv(f"{base}.conv3", w * 4, w, 1)
            add_bn(f"{base}.bn3", w * 4)
            if b == 0:
                add_conv(f"{base}.downsample.0", w * 4, cin, 1)
                add_bn(f"{base}.downsample.1", w * 4)

    params, stats = convert_torchvision_resnet50(sd)

    # structure: init our encoder and compare tree shapes
    enc = ResNet50Encoder()
    x = jnp.zeros((1, 64, 64, 3))
    ref_vars = enc.init(jax.random.key(0), x)
    ref_shapes = jax.tree_util.tree_map(lambda a: a.shape, ref_vars["params"])
    got_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), params)
    assert ref_shapes == got_shapes
    ref_stats_shapes = jax.tree_util.tree_map(lambda a: a.shape,
                                              ref_vars["batch_stats"])
    got_stats_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), stats)
    assert ref_stats_shapes == got_stats_shapes

    # numerics: full converted forward vs torch stem reference on the
    # first conv+bn
    xin = np.random.default_rng(0).normal(size=(1, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        t = F.conv2d(torch.tensor(xin.transpose(0, 3, 1, 2)),
                     sd["conv1.weight"], stride=2, padding=3)
        t = F.batch_norm(t, sd["bn1.running_mean"], sd["bn1.running_var"],
                         sd["bn1.weight"], sd["bn1.bias"], eps=1e-5)
        t = torch.relu(t).numpy().transpose(0, 2, 3, 1)

    from multimodal_rare_disease import nn as fnn

    conv_out = fnn.Conv(64, (7, 7), strides=(2, 2),
                        padding=[(3, 3), (3, 3)], use_bias=False).apply(
        {"params": params["stem_conv"]}, jnp.asarray(xin))
    bn = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5)
    bn_out = bn.apply({"params": params["stem_bn"],
                       "batch_stats": stats["stem_bn"]}, conv_out)
    ours = np.asarray(fnn.relu(bn_out))
    np.testing.assert_allclose(ours, t, atol=1e-4)
