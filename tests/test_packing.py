"""Sequence-packed inference (inference/packing.py + the packed paths
through BertEncoder / MultimodalClassifier).

Cross-document attention scores carry -1e9 bias whose softmax
contribution underflows to exactly 0, and position ids restart per
document — per-document outputs equal the unpacked forward up to f32
reduction-tree order (~2e-7, the same noise as changing the padding
bucket; asserted at atol 1e-5 here). The compiled bf16 graph on the
GPU is checked by chip_smoke.py's predict phase."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from multimodal_rare_disease.inference.packing import (
    PackedBatch,
    pack_texts,
    packing_wins,
)

pytestmark = pytest.mark.smoke


def _toy_batch(rng, n, tmax=40, lo=18, hi=40):
    lens = rng.integers(lo, hi + 1, size=n)
    ids = np.zeros((n, tmax), np.int32)
    mask = np.zeros((n, tmax), np.int32)
    for i, l in enumerate(lens):
        ids[i, :l] = rng.integers(1, 90, size=l)
        mask[i, :l] = 1
    return ids, mask, lens


def test_pack_texts_structure():
    rng = np.random.default_rng(0)
    ids, mask, lens = _toy_batch(rng, 17)
    pb = pack_texts(ids, mask, capacity=128, row_multiple=4)
    assert pb.input_ids.shape[1] == 128
    assert pb.num_rows % 4 == 0
    # every doc is recoverable at (row, slot) with restarted positions
    for i in range(17):
        r, s = int(pb.doc_row[i]), int(pb.doc_slot[i])
        off = int(pb.query_positions[r, s])
        li = int(lens[i])
        np.testing.assert_array_equal(pb.input_ids[r, off:off + li],
                                      ids[i, :li])
        np.testing.assert_array_equal(pb.position_ids[r, off:off + li],
                                      np.arange(li))
        assert (pb.segment_ids[r, off:off + li] == s + 1).all()
    # packing actually packs
    assert pb.tokens_per_doc < 128


def test_pack_rejects_bad_capacity():
    rng = np.random.default_rng(1)
    ids, mask, _ = _toy_batch(rng, 4)
    with pytest.raises(ValueError):
        pack_texts(ids, mask, capacity=96)


def test_packing_wins_heuristic():
    assert packing_wins([80] * 64, bucket=128, capacity=256)
    assert not packing_wins([120] * 64, bucket=128, capacity=256)


def test_packed_bert_bit_exact_vs_unpacked():
    from multimodal_rare_disease.models.bert import BertEncoder

    rng = np.random.default_rng(2)
    n, tmax = 11, 40
    ids, mask, lens = _toy_batch(rng, n, tmax)
    enc = BertEncoder(vocab_size=90, hidden_size=64, num_layers=2,
                      num_heads=4, intermediate_size=128,
                      max_position_embeddings=128, dtype=jnp.float32)
    v = enc.init(jax.random.key(0), jnp.asarray(ids[:1]),
                 jnp.asarray(mask[:1]))

    # unpacked reference: each doc in its own row (same padded length)
    ref = np.asarray(enc.apply(v, jnp.asarray(ids),
                               jnp.asarray(mask))["cls"])

    pb = pack_texts(ids, mask, capacity=128, row_multiple=2)
    out = enc.apply(v, jnp.asarray(pb.input_ids), None,
                    position_ids=jnp.asarray(pb.position_ids),
                    segment_ids=jnp.asarray(pb.segment_ids),
                    query_positions=jnp.asarray(pb.query_positions))
    got = np.asarray(out["cls"])[pb.doc_row, pb.doc_slot]
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_packed_bert_bit_exact_without_cls_only():
    """The non-cls_only packed path (gather at query positions)."""
    from multimodal_rare_disease.models.bert import BertEncoder

    rng = np.random.default_rng(3)
    ids, mask, _ = _toy_batch(rng, 7)
    enc = BertEncoder(vocab_size=90, hidden_size=64, num_layers=1,
                      num_heads=4, intermediate_size=128,
                      max_position_embeddings=128, dtype=jnp.float32)
    v = enc.init(jax.random.key(0), jnp.asarray(ids[:1]),
                 jnp.asarray(mask[:1]))
    ref = np.asarray(enc.apply(v, jnp.asarray(ids),
                               jnp.asarray(mask),
                               cls_only_final=False)["cls"])
    pb = pack_texts(ids, mask, capacity=128)
    out = enc.apply(v, jnp.asarray(pb.input_ids), None,
                    position_ids=jnp.asarray(pb.position_ids),
                    segment_ids=jnp.asarray(pb.segment_ids),
                    query_positions=jnp.asarray(pb.query_positions),
                    cls_only_final=False)
    got = np.asarray(out["cls"])[pb.doc_row, pb.doc_slot]
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_packed_classifier_matches_unpacked():
    from multimodal_rare_disease.config import resolve_config
    from multimodal_rare_disease.models import create_model

    rng = np.random.default_rng(4)
    cfg = resolve_config("default", {
        "text_encoder.num_layers": 1,
        "text_encoder.hidden_size": 64,
        "text_encoder.num_heads": 4,
        "text_encoder.intermediate_size": 128,
        "text_encoder.vocab_size": 90,
        "data.image_size": 32,
    })
    model = create_model(cfg, mode="multimodal", dtype=jnp.float32)
    n = 6
    ids, mask, _ = _toy_batch(rng, n)
    images = jnp.asarray(rng.normal(size=(n, 32, 32, 3)), jnp.float32)
    v = model.init(jax.random.key(0), images[:1], jnp.asarray(ids[:1]),
                   jnp.asarray(mask[:1]), train=False)
    ref = np.asarray(model.apply(v, images, jnp.asarray(ids),
                                 jnp.asarray(mask), train=False)["probs"])
    pb = pack_texts(ids, mask, capacity=128)
    got = np.asarray(model.apply(
        v, images, jnp.asarray(pb.input_ids),
        jnp.asarray(pb.position_ids), jnp.asarray(pb.segment_ids),
        jnp.asarray(pb.query_positions), jnp.asarray(pb.doc_row),
        jnp.asarray(pb.doc_slot),
        method="packed_forward")["probs"])
    np.testing.assert_allclose(got, ref, atol=1e-5)
