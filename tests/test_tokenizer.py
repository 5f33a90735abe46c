import numpy as np
import pytest

from multimodal_rare_disease.config import resolve_config
from multimodal_rare_disease.data.clinical_text import (
    ClinicalTextAugmenter,
    load_clinical_descriptions,
)
from multimodal_rare_disease.data.tokenizer import (
    CLS,
    PAD,
    SEP,
    UNK,
    BasicTokenizer,
    BertWordPieceTokenizer,
    build_wordpiece_vocab,
    get_tokenizer,
)


def test_basic_tokenizer_punct_and_whitespace():
    bt = BasicTokenizer()
    assert bt.tokenize("Hello, world!") == ["Hello", ",", "world", "!"]
    assert bt.tokenize("  a\tb\nc ") == ["a", "b", "c"]
    assert bt.tokenize("micrognathia (small jaw)") == [
        "micrognathia", "(", "small", "jaw", ")"]


def test_basic_tokenizer_lowercase_accents():
    bt = BasicTokenizer(do_lower_case=True)
    assert bt.tokenize("Café NAÏVE") == ["cafe", "naive"]


def test_wordpiece_greedy_longest_match():
    vocab = {t: i for i, t in enumerate(
        [PAD, UNK, CLS, SEP, "[MASK]", "un", "##aff", "##able", "##ected",
         "aff", "able"])}
    tok = BertWordPieceTokenizer(vocab)
    assert tok.wordpiece("unaffable") == ["un", "##aff", "##able"]
    assert tok.wordpiece("unaffected") == ["un", "##aff", "##ected"]
    assert tok.wordpiece("zzz") == [UNK]


def test_encode_fixed_shape_contract():
    corpus = ["synophrys and long eyelashes", "wide mouth with full lips"]
    tok = BertWordPieceTokenizer(build_wordpiece_vocab(corpus))
    ids, mask, types = tok.encode("synophrys with wide mouth", max_length=16)
    assert ids.shape == (16,) and mask.shape == (16,) and types.shape == (16,)
    assert ids.dtype == np.int32
    assert ids[0] == tok.cls_id
    n = int(mask.sum())
    assert ids[n - 1] == tok.sep_id
    assert (ids[n:] == tok.pad_id).all()
    # roundtrip: no UNK for in-corpus words
    assert UNK not in tok.convert_ids_to_tokens(ids[:n])


def test_encode_truncation():
    corpus = ["a b c d e f g h i j k l"]
    tok = BertWordPieceTokenizer(build_wordpiece_vocab(corpus))
    ids, mask, _ = tok.encode(" ".join("abcdefghijkl"), max_length=8)
    assert mask.sum() == 8
    assert ids[0] == tok.cls_id and ids[7] == tok.sep_id


def test_encode_batch_and_decode():
    cfg = resolve_config()
    desc = load_clinical_descriptions(cfg)
    texts = [d["clinical_description"] for d in desc.values()]
    tok = get_tokenizer(corpus=texts)
    ids, mask, types = tok.encode_batch(texts[:4], max_length=64)
    assert ids.shape == (4, 64)
    out = tok.decode(ids[0])
    assert "rare" in out or "syndrome" in out.lower()


def test_vocab_roundtrip_file(tmp_path):
    corpus = ["hypertelorism ptosis synophrys"]
    tok = BertWordPieceTokenizer(build_wordpiece_vocab(corpus))
    p = tmp_path / "vocab.txt"
    tok.save_vocab(p)
    tok2 = BertWordPieceTokenizer.from_vocab_file(p)
    assert tok2.vocab == tok.vocab
    a = tok.encode("hypertelorism unknownword", 16)[0]
    b = tok2.encode("hypertelorism unknownword", 16)[0]
    np.testing.assert_array_equal(a, b)


def test_clinical_descriptions_all_classes():
    cfg = resolve_config()
    desc = load_clinical_descriptions(cfg)
    for name in cfg.syndrome_names:
        assert name in desc
        assert desc[name]["clinical_description"]
        assert len(desc[name]["key_facial_features"]) >= 3


def test_text_augmenter_levels_deterministic():
    cfg = resolve_config()
    desc = load_clinical_descriptions(cfg)
    rng = np.random.default_rng(42)
    aug = ClinicalTextAugmenter(desc, rng=rng)
    name = cfg.syndrome_names[0]
    l0 = aug.augment(name, 0)
    assert l0 == desc[name]["clinical_description"]
    l1 = aug.augment(name, 1)
    assert "Facial dysmorphism" in l1 and name in l1
    l2 = aug.augment(name, 2)
    assert "Physical examination" in l2
    l3 = aug.augment(name, 3)
    assert any(feat in l3 for feat in desc[name]["key_facial_features"])
    # unknown syndrome fallback
    assert "consistent with Nope" in aug.augment("Nope", 1)
    # determinism under same seed
    aug2 = ClinicalTextAugmenter(desc, rng=np.random.default_rng(42))
    assert [aug2.augment(name, i) for i in range(4)] == [l0, l1, l2, l3]
