"""BERT-compatible WordPiece tokenizer, torch/HF-free.

Replaces the reference's dependency on HF `AutoTokenizer`
(`src/text_encoder.py:296`, `src/text_dataset_loader.py:354-412`) with a
self-contained implementation of the same algorithm:

- BasicTokenizer: text cleanup, whitespace split, punctuation split,
  CJK char spacing, optional lowercase + accent stripping (BioBERT is
  *cased*, so default do_lower_case=False)
- WordPiece: greedy longest-match-first with "##" continuations,
  max 100 chars/word → [UNK]

Loads a standard `vocab.txt` (one token per line — drop-in compatible
with a real BioBERT vocab supplied offline); when none is available,
`build_wordpiece_vocab` derives a deterministic vocabulary from a text
corpus so the whole framework runs hermetically.

Output is fixed-shape (pad-to-max) int32 arrays — exactly what XLA wants
(SURVEY.md §5 "long-context" note).

A C-accelerated encode path (ops/native) plugs in behind the same API
for the ≥5k pairs/sec host-side budget.
"""

from __future__ import annotations

import json
import unicodedata
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIAL_TOKENS = (PAD, UNK, CLS, SEP, MASK)


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = False):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._space_cjk(text)
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            tokens.extend(self._split_punct(tok))
        return tokens

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _space_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punct(tok: str) -> List[str]:
        out: List[List[str]] = []
        start_new = True
        for ch in tok:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                    start_new = False
                out[-1].append(ch)
        return ["".join(x) for x in out if x]


class BertWordPieceTokenizer:
    """Full BERT tokenizer: basic split + WordPiece + fixed-shape encode."""

    def __init__(
        self,
        vocab: Dict[str, int],
        do_lower_case: bool = False,
        max_input_chars_per_word: int = 100,
    ):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.basic = BasicTokenizer(do_lower_case=do_lower_case)
        self.max_input_chars_per_word = max_input_chars_per_word
        for sp in SPECIAL_TOKENS:
            if sp not in self.vocab:
                raise ValueError(f"vocab missing special token {sp}")
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_vocab_file(cls, path: str | Path, do_lower_case: bool = False
                        ) -> "BertWordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, do_lower_case=do_lower_case)

    def save_vocab(self, path: str | Path) -> None:
        items = sorted(self.vocab.items(), key=lambda kv: kv[1])
        with open(path, "w", encoding="utf-8") as f:
            for tok, _ in items:
                f.write(tok + "\n")

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- tokenization ------------------------------------------------------

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [UNK]
        pieces: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self.basic.tokenize(text):
            out.extend(self.wordpiece(tok))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.ids_to_tokens.get(int(i), UNK) for i in ids]

    # -- fixed-shape encoding ---------------------------------------------

    def encode(
        self, text: str, max_length: int = 128
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """→ (input_ids, attention_mask, token_type_ids), each [max_length] int32.

        Layout: [CLS] tokens... [SEP] pad..., truncating tokens to
        max_length-2 (matches HF `tokenizer(text, truncation=True,
        padding='max_length')`, ref `src/predict.py:111-118`).
        """
        ids = self.convert_tokens_to_ids(self.tokenize(text))[: max_length - 2]
        seq = [self.cls_id] + ids + [self.sep_id]
        n = len(seq)
        input_ids = np.full((max_length,), self.pad_id, np.int32)
        input_ids[:n] = seq
        mask = np.zeros((max_length,), np.int32)
        mask[:n] = 1
        return input_ids, mask, np.zeros((max_length,), np.int32)

    def encode_batch(
        self, texts: Iterable[str], max_length: int = 128,
        use_native: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        texts = list(texts)
        if use_native:
            out = self._native_encode_batch(texts, max_length)
            if out is not None:
                return out
        rows = [self.encode(t, max_length) for t in texts]
        ids = np.stack([r[0] for r in rows])
        mask = np.stack([r[1] for r in rows])
        types = np.stack([r[2] for r in rows])
        return ids, mask, types

    # -- native (C++) fast path -------------------------------------------

    _native_handle = None
    _native_lib = None

    def _native_ok(self, texts) -> bool:
        """The C++ core is byte-exact for ASCII text only: it classifies
        whitespace/punctuation/control with ASCII tables, so any non-ASCII
        input (en-dashes, NBSP, accents, CJK, ...) could tokenize
        differently from the Python reference path. Route all non-ASCII
        batches to Python so training (encode) and inference (encode_batch)
        always agree."""
        return all(t.isascii() for t in texts)

    def _native_encode_batch(self, texts, max_length: int):
        try:
            from multimodal_rare_disease.native import wordpiece_lib
        except Exception:  # noqa: BLE001
            return None
        lib = wordpiece_lib()
        if lib is None or not self._native_ok(texts):
            return None
        import ctypes

        if self._native_handle is None:
            blob = "\n".join(
                t for t, _ in sorted(self.vocab.items(), key=lambda kv: kv[1])
            ).encode("utf-8")
            self._native_lib = lib
            self._native_handle = lib.wp_create(blob, len(blob))

        encoded = [t.encode("utf-8") for t in texts]
        offsets = np.zeros(len(texts) + 1, np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        blob = b"".join(encoded)
        n = len(texts)
        ids = np.zeros((n, max_length), np.int32)
        mask = np.zeros((n, max_length), np.int32)
        lib.wp_encode_batch(
            self._native_handle, blob,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, max_length, int(self.basic.do_lower_case),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return ids, mask, np.zeros((n, max_length), np.int32)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        toks = self.convert_ids_to_tokens(ids)
        if skip_special_tokens:
            toks = [t for t in toks if t not in SPECIAL_TOKENS]
        text = " ".join(toks).replace(" ##", "")
        return text


def build_wordpiece_vocab(
    corpus: Iterable[str],
    vocab_size: int = 8192,
    do_lower_case: bool = False,
    min_freq: int = 1,
) -> Dict[str, int]:
    """Deterministic WordPiece vocabulary from a corpus.

    Strategy (training-free, suited to the small clinical corpus):
    specials + every observed character (+ its "##" form) + the most
    frequent whole words + the most frequent word suffixes as "##"
    continuations. Greedy longest-match then reconstructs frequent words
    exactly and backs off to subwords for the rest.
    """
    basic = BasicTokenizer(do_lower_case=do_lower_case)
    word_counts: Counter = Counter()
    for text in corpus:
        word_counts.update(basic.tokenize(text))

    vocab: Dict[str, int] = {}

    def add(tok: str):
        if tok and tok not in vocab:
            vocab[tok] = len(vocab)

    for sp in SPECIAL_TOKENS:
        add(sp)
    chars = sorted({ch for w in word_counts for ch in w})
    for ch in chars:
        add(ch)
        add("##" + ch)

    # frequent whole words
    for w, c in sorted(word_counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if c < min_freq or len(vocab) >= vocab_size:
            break
        add(w)

    # frequent suffix pieces from remaining budget
    suffix_counts: Counter = Counter()
    for w, c in word_counts.items():
        for i in range(1, len(w)):
            if len(w) - i <= 12:
                suffix_counts[w[i:]] += c
    for s, c in sorted(suffix_counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if len(vocab) >= vocab_size:
            break
        add("##" + s)

    return vocab


_DEFAULT_TOKENIZER: Optional[BertWordPieceTokenizer] = None


def get_tokenizer(
    vocab_file: Optional[str] = None,
    corpus: Optional[Iterable[str]] = None,
    vocab_size: int = 8192,
) -> BertWordPieceTokenizer:
    """Tokenizer resolution (parity role of `get_tokenizer`,
    `src/text_encoder.py:296`): explicit vocab file → corpus-built →
    default clinical-corpus-built (cached)."""
    global _DEFAULT_TOKENIZER
    if vocab_file:
        return BertWordPieceTokenizer.from_vocab_file(vocab_file)
    if corpus is not None:
        return BertWordPieceTokenizer(build_wordpiece_vocab(corpus, vocab_size))
    if _DEFAULT_TOKENIZER is None:
        from multimodal_rare_disease.config import get_config
        from multimodal_rare_disease.data.clinical_text import (
            default_tokenizer_corpus,
        )

        texts = default_tokenizer_corpus(get_config())
        _DEFAULT_TOKENIZER = BertWordPieceTokenizer(
            build_wordpiece_vocab(texts, vocab_size)
        )
    return _DEFAULT_TOKENIZER
