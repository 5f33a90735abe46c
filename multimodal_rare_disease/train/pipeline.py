"""Host-side data pipeline: corpus → fixed-shape device batches.

Replaces the reference's torch Dataset/DataLoader stack
(`MultimodalSyndromeDataset` `src/train_multimodal.py:132-310`, inline
train/val datasets `:797-876`, `WeightedRandomSampler` `:879-888`) with a
device-first design:

- the (small) decoded corpus lives in host RAM as one uint8 array;
  augmentation runs ON DEVICE inside the jitted train step, so the host
  only gathers rows and the augmentation_factor multiplies sampler draws,
  not host work
- clinical text variants are pre-generated per (class, level) into a
  tokenized pool (ids/mask arrays), so per-batch text augmentation is an
  integer gather instead of re-tokenization (behavioral parity with
  `ClinicalTextAugmenter` sampling a fresh template per item)
- every batch has the same static shapes; the final val batch is padded
  and carries a `valid` mask so metrics stay exact
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from multimodal_rare_disease.config import (
    Config,
    SYNDROME_NAMES,
    find_image_dir,
)
from multimodal_rare_disease.data.clinical_text import (
    ClinicalTextAugmenter,
    load_clinical_descriptions,
)
from multimodal_rare_disease.data.images import (
    ImageSample,
    WeightedSampler,
    class_weights,
    configure_face_detection,
    leakage_aware_split,
    load_corpus_arrays,
    sample_weights,
    scan_image_corpus,
    stratified_split,
)
from multimodal_rare_disease.data.tokenizer import (
    BertWordPieceTokenizer,
    get_tokenizer,
)
from multimodal_rare_disease.utils.rng import RngStreams

STAGING_SIZE = 256  # host decode size; device crops/resizes to image_size
TEXT_POOL_VARIANTS = 16  # pre-generated text variants per (class, level)
NUM_TEXT_LEVELS = 4


@dataclass
class TextPool:
    """Tokenized text variants: ids/mask [C, L, V, T]."""

    ids: np.ndarray
    mask: np.ndarray

    def gather(self, labels: np.ndarray, levels: np.ndarray,
               variants: np.ndarray):
        return (self.ids[labels, levels, variants],
                self.mask[labels, levels, variants])


def build_text_pool(
    cfg: Config,
    tokenizer: BertWordPieceTokenizer,
    rng: np.random.Generator,
    descriptions: Optional[dict] = None,
) -> TextPool:
    desc = descriptions or load_clinical_descriptions(cfg)
    aug = ClinicalTextAugmenter(desc, rng)
    T = cfg.data.max_text_length
    C, L, V = len(SYNDROME_NAMES), NUM_TEXT_LEVELS, TEXT_POOL_VARIANTS
    ids = np.zeros((C, L, V, T), np.int32)
    mask = np.zeros((C, L, V, T), np.int32)
    for c, name in enumerate(SYNDROME_NAMES):
        for lvl in range(L):
            for v in range(V):
                text = aug.augment(name, lvl)
                i, m, _ = tokenizer.encode(text, T)
                ids[c, lvl, v] = i
                mask[c, lvl, v] = m
    return TextPool(ids, mask)


class DataPipeline:
    """Train/val batch source for one mode over the image corpus."""

    def __init__(
        self,
        cfg: Config,
        mode: str = "multimodal",
        rngs: Optional[RngStreams] = None,
        image_dir: Optional[str] = None,
        tokenizer: Optional[BertWordPieceTokenizer] = None,
        samples: Optional[Sequence[ImageSample]] = None,
    ):
        self.cfg = cfg
        self.mode = mode
        self.rngs = rngs or RngStreams(cfg.seed)

        if samples is None:
            d = image_dir or find_image_dir(cfg)
            if d is None:
                raise FileNotFoundError("no image directory found in data roots")
            samples = scan_image_corpus(d)
        samples = list(samples)

        # leakage-aware when the corpus contains augmented variants
        has_aug = any(s.base_id != __import__("pathlib").Path(s.path).stem
                      for s in samples)
        split_rng = self.rngs.host("split")
        if has_aug:
            self.train_samples, self.val_samples = leakage_aware_split(
                samples, cfg.data.val_ratio, rng=split_rng)
        else:
            self.train_samples, self.val_samples = stratified_split(
                samples, cfg.data.val_ratio, rng=split_rng)

        if mode == "text_only":
            # labels only — decoding + face-cropping the image corpus
            # would be pure waste here (device_corpus/train_batches never
            # ship images in this mode, but MTCNN over the corpus costs
            # minutes of host time per pipeline build)
            self.train_images = np.zeros((0,), np.uint8)
            self.val_images = np.zeros((0,), np.uint8)
            self.train_labels = np.asarray(
                [s.label for s in self.train_samples], np.int32)
            self.val_labels = np.asarray(
                [s.label for s in self.val_samples], np.int32)
        else:
            configure_face_detection(cfg)
            self.train_images, self.train_labels = load_corpus_arrays(
                self.train_samples, STAGING_SIZE)
            self.val_images, self.val_labels = load_corpus_arrays(
                self.val_samples, STAGING_SIZE)

        self.class_weights = class_weights(self.train_samples)
        self._sampler = WeightedSampler(
            sample_weights(self.train_samples),
            num_samples=len(self.train_samples) * max(1, cfg.data.augmentation_factor),
            rng=self.rngs.host("sampler"),
        ) if cfg.data.use_weighted_sampling else None

        if mode in ("multimodal", "text_only"):
            self.tokenizer = tokenizer or get_tokenizer()
            self.text_pool = build_text_pool(cfg, self.tokenizer,
                                             self.rngs.host("text_aug"))
        else:
            self.tokenizer = None
            self.text_pool = None

        self._text_rng = self.rngs.host("text_pick")

    # -- helpers -----------------------------------------------------------

    @property
    def steps_per_epoch(self) -> int:
        """Number of train batches actually yielded per epoch.

        Always floor(draws / batch_size): the index iterators drop the
        ragged tail unconditionally (static batch shapes), so the LR
        schedule length, resume step counter, and logged steps must agree
        with floor — a ceil here would desynchronize them.
        """
        n = (len(self.train_samples)
             * max(1, self.cfg.data.augmentation_factor))
        b = self.cfg.training.batch_size
        if n < b:
            raise ValueError(
                f"epoch draw ({n} = {len(self.train_samples)} samples x "
                f"augmentation_factor) is smaller than batch_size ({b}); "
                "reduce training.batch_size or raise data.augmentation_factor")
        return n // b

    def _indices_for_epoch(self) -> np.ndarray:
        n_draw = len(self.train_samples) * max(1, self.cfg.data.augmentation_factor)
        if self._sampler is not None:
            return self._sampler.sample_epoch()
        idx = np.concatenate([
            self.rngs.host("shuffle").permutation(len(self.train_samples))
            for _ in range(max(1, self.cfg.data.augmentation_factor))])
        return idx[:n_draw]

    def _text_indices(self, rows: np.ndarray, train: bool
                      ) -> tuple[np.ndarray, np.ndarray]:
        """(levels, variants) into the text pool for these corpus rows.

        Base policy: random (level, variant) per train item — behavioral
        parity with `ClinicalTextAugmenter` drawing a fresh template per
        sample — and the full clinical description (0, 0) at val.
        Subclasses (FGDD cycle-pairing) override this to pick texts as a
        function of the corpus row instead.
        """
        n = len(rows)
        if train:
            return (self._text_rng.integers(0, NUM_TEXT_LEVELS, n),
                    self._text_rng.integers(0, TEXT_POOL_VARIANTS, n))
        return np.zeros(n, np.int64), np.zeros(n, np.int64)

    def _attach_text(self, batch: Dict[str, np.ndarray], rows: np.ndarray,
                     labels: np.ndarray, train: bool) -> None:
        if self.text_pool is None:
            return
        levels, variants = self._text_indices(rows, train)
        ids, mask = self.text_pool.gather(labels, levels, variants)
        batch["input_ids"] = ids
        batch["attention_mask"] = mask

    # -- device-resident corpus (index-batch) mode ---------------------------
    #
    # The whole decoded corpus + tokenized text pools live in HBM once;
    # per step only tiny int32 index arrays cross the host↔device boundary
    # and the batch is gathered on device, instead of a per-batch image
    # transfer.

    def device_corpus(self) -> Dict[str, np.ndarray]:
        corpus: Dict[str, np.ndarray] = {
            "train_labels": self.train_labels.astype(np.int32),
            "val_labels": self.val_labels.astype(np.int32),
        }
        if self.mode != "text_only":
            corpus["train_images"] = self.train_images
            corpus["val_images"] = self.val_images
        if self.text_pool is not None:
            corpus["pool_ids"] = self.text_pool.ids
            corpus["pool_mask"] = self.text_pool.mask
        return corpus

    def train_index_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        B = self.cfg.training.batch_size
        idx = self._indices_for_epoch()
        for s in range(len(idx) // B):
            rows = idx[s * B:(s + 1) * B].astype(np.int32)
            out = {"rows": rows}
            if self.text_pool is not None:
                levels, variants = self._text_indices(rows, train=True)
                out["levels"] = levels.astype(np.int32)
                out["variants"] = variants.astype(np.int32)
            yield out

    def val_index_batches(self, batch_size: Optional[int] = None
                          ) -> Iterator[Dict[str, np.ndarray]]:
        B = batch_size or self.cfg.evaluation.eval_batch_size
        n = len(self.val_samples)
        for s in range(0, n, B):
            rows = np.arange(s, min(s + B, n), dtype=np.int32)
            pad = B - len(rows)
            valid = np.ones(len(rows), np.float32)
            if pad:
                rows = np.concatenate([rows, np.zeros(pad, np.int32)])
                valid = np.concatenate([valid, np.zeros(pad, np.float32)])
            out = {"rows": rows, "valid": valid}
            if self.text_pool is not None:
                levels, variants = self._text_indices(rows, train=False)
                out["levels"] = levels.astype(np.int32)
                out["variants"] = variants.astype(np.int32)
            yield out

    # -- batch iterators ---------------------------------------------------

    def train_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        B = self.cfg.training.batch_size
        idx = self._indices_for_epoch()
        n_full = len(idx) // B
        for s in range(n_full):
            rows = idx[s * B:(s + 1) * B]
            labels = self.train_labels[rows]
            batch: Dict[str, np.ndarray] = {"labels": labels,
                                            "valid": np.ones(B, np.float32)}
            if self.mode != "text_only":
                batch["images"] = self.train_images[rows]
            self._attach_text(batch, rows, labels, train=True)
            yield batch

    def val_batches(self, batch_size: Optional[int] = None
                    ) -> Iterator[Dict[str, np.ndarray]]:
        B = batch_size or self.cfg.evaluation.eval_batch_size
        n = len(self.val_samples)
        for s in range(0, n, B):
            rows = np.arange(s, min(s + B, n))
            pad = B - len(rows)
            labels = self.val_labels[rows]
            valid = np.ones(len(rows), np.float32)
            if pad:
                rows = np.concatenate([rows, np.zeros(pad, np.int64)])
                labels = np.concatenate([labels, np.zeros(pad, np.int32)])
                valid = np.concatenate([valid, np.zeros(pad, np.float32)])
            batch: Dict[str, np.ndarray] = {"labels": labels, "valid": valid}
            if self.mode != "text_only":
                batch["images"] = self.val_images[rows]
            self._attach_text(batch, rows, labels, train=False)
            yield batch
